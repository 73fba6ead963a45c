"""AlexNet, the paper's primary evaluation network (Sec. VI): the full spec for
the energy and statistics accounting, and the mini variant the experiments train."""
from repro_torch.models.cnn import ALEXNET as CONFIG, ALEXNET_MINI as CONFIG_MINI  # noqa: F401

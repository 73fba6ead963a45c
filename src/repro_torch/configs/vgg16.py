"""VGG-16, the paper's second evaluation network (Sec. VI-C/D), and its mini variant."""
from repro_torch.models.cnn import VGG16 as CONFIG, VGG_MINI as CONFIG_MINI  # noqa: F401

"""The port's examples (``repro_torch.experiments.quickstart`` and
``repro_torch.experiments.serve_quantized``, the JAX package's
``examples/quickstart.py`` and ``examples/serve_quantized.py``) on the CPU.

Each runs at a small step count in a process of its own and exits 0:
quickstart; serve_quantized with ``--metrics-out``, whose snapshot
``python -m repro_torch.obs --validate`` accepts; ``--speculative``; and the
multi-rank leg under ``torchrun`` on two ``gloo`` ranks. Each exits nonzero on
drift: a reloaded artifact whose forward differs, served tokens that differ from
their static generation.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.experiments import quickstart, serve_quantized  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
STEPS = "5"  # training steps: the checks are of the paths, not of the model's quality


def _run(args, **env) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="2", **env, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out


def test_quickstart_runs_on_the_cpu():
    out = _run(["-m", "repro_torch.experiments.quickstart", "--device", "cpu", "--steps", "20"])
    assert "reload forward bit-identical: True" in out.stdout


def test_serve_quantized_writes_a_valid_snapshot(tmp_path):
    path = str(tmp_path / "metrics.json")
    out = _run(["-m", "repro_torch.experiments.serve_quantized", "--device", "cpu",
                "--metrics-out", path], SERVE_DEMO_STEPS=STEPS)
    assert out.stdout.count("(parity: True)") == 4
    assert "reloaded generate bit-identical: True" in out.stdout
    _run(["-m", "repro_torch.obs", "--validate", path])


def test_serve_quantized_speculative():
    out = _run(["-m", "repro_torch.experiments.serve_quantized", "--device", "cpu",
                "--speculative"], SERVE_DEMO_STEPS=STEPS)
    assert out.stdout.count("(identity: True)") == 8


def test_serve_quantized_on_two_ranks():
    """The multi-rank leg: ``torchrun`` starts two ranks, each trains the same model,
    and the engine's elastic mesh serves the packed tree over a ``gloo`` group."""
    out = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                "-m", "repro_torch.experiments.serve_quantized", "--device", "cpu"],
               SERVE_DEMO_STEPS=STEPS)
    assert out.stdout.count("on 2 rank(s)") == 2
    assert out.stdout.count("(parity: True)") == 8


def test_quickstart_exits_nonzero_on_drift(monkeypatch):
    real = quickstart.round_trip

    def drifted(qm, x, path, device=None):
        first, again, _ = real(qm, x, path, device)
        return first, again + 1, False

    monkeypatch.setattr(quickstart, "round_trip", drifted)
    with pytest.raises(SystemExit, match="drifted"):
        quickstart.main(["--device", "cpu", "--steps", "20"])


@pytest.mark.parametrize("speculative", [False, True])
def test_serve_quantized_exits_nonzero_on_drift(monkeypatch, speculative):
    real = serve_quantized._static
    monkeypatch.setenv("SERVE_DEMO_STEPS", STEPS)
    monkeypatch.setattr(serve_quantized, "_static",
                        lambda *a: np.asarray(real(*a)) + 1)  # every reference token off by one
    args = ["--device", "cpu"] + (["--speculative"] if speculative else [])
    with pytest.raises(SystemExit, match="NOT token-identical|drifted"):
        serve_quantized.main(args)

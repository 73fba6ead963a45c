"""The port's dry-run (``launch/dryrun.py``) and its helpers against the JAX package's.

* ``SHAPES``, ``applicable_shapes``, ``input_specs`` (shapes and dtypes) and
  ``model_flops`` for every ``ARCH_IDS`` x applicable shape: exact;
* ``abstract_quantize_tree`` leaf by leaf (shape, dtype, nibble, logical
  shape, format) for every architecture at full width in elp4 and elp8,
  against the reference's ``jax.eval_shape`` tree;
* the dry-run of a reduced config of each family on a ``(2, 2)`` fake-rank
  mesh (train, prefill, decode) against the reference's ``_lower_cell`` and
  ``body_probe.corrected_totals`` on 4 fake devices
  (``tests/torch_dryrun_ref.py``, one subprocess);
* one full-width cell of each family on the 16 x 16 production mesh, run to
  ``ok`` in a subprocess (the fake 256-rank group becomes the default process
  group of the process that starts it), and the command line's JSON.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dryrun_ref as REF  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import applicable_shapes as j_applicable  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    applicable_shapes,
    get_config,
    input_specs,
)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]


def test_shapes_match_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in J_SHAPES.items()}
    for a in ARCH_IDS:
        assert applicable_shapes(get_config(a)) == j_applicable(jget(a))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_match_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    got, want = input_specs(cfg, shape), j_input_specs(jcfg, shape)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.is_meta and tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
    assert dryrun.model_flops(cfg, SHAPES[shape]) == _j_model_flops(jcfg, J_SHAPES[shape])


def _j_model_flops(cfg, shape):
    # the reference's ``launch/dryrun.py`` asks for 512 devices at import, which this
    # process's jax may already have fixed: its formula, verbatim
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _leaves(tree, packed_type, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, packed_type, f"{prefix}/{k}"))
    elif isinstance(tree, packed_type):
        out[prefix] = tree
    else:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("fmt", ["elp4", "elp8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_quantize_tree_matches_the_reference(arch, fmt):
    from repro.kernels.ops import PackedWeight as JPacked
    from repro.models import get_model as jmodel
    from repro.runtime.quantized_params import abstract_quantize_tree as j_abstract

    from repro_torch.kernels.ops import PackedWeight
    from repro_torch.runtime.quantized_params import abstract_quantize_tree
    from repro_torch.runtime.train_loop import whole_shapes

    cfg, jcfg = get_config(arch), jget(arch)
    got = _leaves(abstract_quantize_tree(whole_shapes(cfg), cfg, fmt), PackedWeight)
    jtree = j_abstract(jax.eval_shape(lambda: jmodel(jcfg).init_params(jcfg, jax.random.PRNGKey(0))),
                       jcfg, fmt)
    want = _leaves(jtree, JPacked)
    assert sorted(got) == sorted(want)
    n_packed = 0
    for path, leaf in got.items():
        w = want[path]
        if isinstance(leaf, PackedWeight):
            n_packed += 1
            assert isinstance(w, JPacked), path
            for name in ("codes", "sf"):
                t, jt = getattr(leaf, name), getattr(w, name)
                assert t.is_meta and tuple(t.shape) == tuple(jt.shape), (path, name)
                assert str(t.dtype).removeprefix("torch.") == str(jt.dtype), (path, name)
            assert (leaf.nibble, tuple(leaf.shape), leaf.fmt_name) == (
                bool(w.nibble), tuple(w.shape), w.fmt_name), path
        else:
            assert tuple(leaf.shape) == tuple(w.shape), path
            assert str(leaf.dtype).removeprefix("torch.") == str(w.dtype), path
    assert n_packed > 0


# ---------------------------------------------------------------------------
# The dry-run on a (2, 2) mesh against the reference's
# ---------------------------------------------------------------------------
# Cells whose argument bytes differ by a port choice or by what XLA prunes, each named:
ARG_DIFFERS = {
    # XLA drops a parameter that the program never reads: the prefill overwrites
    # mamba2's conv and SSD state from zero without reading them
    ("mamba2_780m", "prefill"),
    # recurrentgemma-2b's one KV head is whole on each rank of the ring cache, where
    # the reference's cache_spec shards its head_dim (ROADMAP.md queue 3, port
    # choices); the prefill's ring is also written without being read
    ("recurrentgemma_2b", "prefill"), ("recurrentgemma_2b", "decode"),
    # XLA drops the weights that a decode step never reads: the enc-dec model's
    # encoder, the vlm's frontend projection
    ("seamless_m4t_large_v2", "decode"), ("internvl2_26b", "decode"),
}
# mamba2's decode step never reads its position (the state carries it): XLA drops it
POS_UNREAD = {"mamba2_780m"}


def _env(**extra) -> dict:
    return dict(os.environ, **extra, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


REF_PROCS = 3  # the reference's cells in three processes at once

FULL = (("qwen3_8b", "decode_32k", "elp4"), ("olmoe_1b_7b", "prefill_32k", None),
        ("mamba2_780m", "decode_32k", None), ("recurrentgemma_2b", "decode_32k", None),
        ("seamless_m4t_large_v2", "prefill_32k", None), ("internvl2_26b", "prefill_32k", None))


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The subprocesses, started together: the reference's dry-run on 4 fake devices
    (its families split over :data:`REF_PROCS` processes),
    the full-width cells (but the first) through ``run_cell``, and the first through
    the command line."""
    d = tmp_path_factory.mktemp("dryrun")
    ref = [subprocess.Popen(
        [sys.executable, REF.__file__, str(d / f"ref{i}.npz"), *REF.ARCHS[i::REF_PROCS]],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in range(REF_PROCS)]
    code = ("import sys, json; from repro_torch.launch import dryrun\n"
            f"cells = {FULL[1:]!r}\n"
            "recs = [dryrun.run_cell(a, s, False, sys.argv[1], quant=q, verbose=False)"
            " for a, s, q in cells]\n"
            "print(json.dumps([[r['arch'], r['status'], r.get('error')] for r in recs]))\n")
    full = subprocess.Popen([sys.executable, "-c", code, str(d)], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    arch, shape, quant = FULL[0]
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--quant", quant, "--out", str(d)], env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield d, {"ref": ref, "full": full, "cli": cli}
    for p in (*ref, full, cli):
        if p.poll() is None:
            p.kill()
            p.communicate()


def _finished(proc) -> str:
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def cells(procs):
    d, ps = procs
    port = {}
    for arch in REF.ARCHS:
        cfg = get_config(arch).reduced()
        for kind, seq, batch in REF.SHAPES:
            with dryrun.fake_group(4):
                port[arch, kind] = dryrun.count_cell(cfg, ShapeConfig(kind, seq, batch, kind),
                                                     dryrun.grid_mesh(REF.MESH))
    ref = {}
    for i, proc in enumerate(ps["ref"]):
        _finished(proc)
        ref.update(np.load(d / f"ref{i}.npz"))
    return port, ref


CELL_IDS = [(a, k) for a in REF.ARCHS for k, _, _ in REF.SHAPES]


@pytest.mark.parametrize("arch,kind", CELL_IDS)
def test_argument_bytes_match_the_reference(cells, arch, kind):
    """Exact where the port keeps the reference's rule blocks: the parameters, the
    ZeRO-1 optimizer state, the cache and the inputs. A decode step's position is
    a Python int in the port and a 4-byte scalar argument in the reference. The
    cells of ``ARG_DIFFERS`` hold more in the port, for the reasons named there."""
    port, ref = cells
    got = port[arch, kind]["memory"]["argument_bytes"]
    pos = 4 if kind == "decode" and arch not in POS_UNREAD else 0
    want = ref[f"{arch}/{kind}/argument_bytes"] - pos
    print(f"{arch} {kind}: argument bytes port {got}, reference {want}")
    if (arch, kind) in ARG_DIFFERS:
        assert got > want
    else:
        assert got == want


@pytest.mark.parametrize("arch,kind", CELL_IDS)
def test_flops_and_wire_bytes_against_the_reference(cells, arch, kind):
    """Ratios only. XLA's cost analysis counts elementwise FLOPs (norms, softmax,
    RoPE, the optimizer's update, the scans' arithmetic) that
    ``FlopCounterMode`` does not, so the port's FLOPs are 0.5-1.05 of XLA's
    (the reduced configs' widths make that share large). GSPMD picks its own
    collectives (``all-to-all`` and ``collective-permute`` reshardings that the
    port does not do, and the other way round), so the wire bytes are held within
    a factor of 20 either way, both nonzero."""
    port, ref = cells
    rec = port[arch, kind]
    flops = rec["cost"]["flops_per_device"] / ref[f"{arch}/{kind}/flops"]
    wire = rec["collectives"]["per_device_bytes"] / ref[f"{arch}/{kind}/coll_bytes"]
    print(f"{arch} {kind}: port/reference FLOPs {flops:.3f}, wire bytes {wire:.3f}")
    assert 0.5 <= flops <= 1.05
    assert 1 / 20 <= wire <= 20
    assert rec["corrected"]["flops"] == rec["cost"]["flops_per_device"]


# ---------------------------------------------------------------------------
# Full width on the production mesh
# ---------------------------------------------------------------------------
def test_full_width_cells_on_the_production_mesh(procs):
    """One cell of each family (dense, moe, ssm, hybrid, audio, vlm) at full width on
    the 16 x 16 mesh, in processes of their own, each ``ok``; the qwen3-8b decode
    cell through the command line, with its JSON's keys."""
    d, ps = procs
    status = json.loads(_finished(ps["full"]).strip().splitlines()[-1])
    assert all(s == "ok" for _, s, _ in status), status
    assert _finished(ps["cli"]).strip().splitlines()[-1].startswith("1/1 cells OK")
    arch, shape, quant = FULL[0]
    with open(d / f"{arch}__{shape}__16x16__{quant}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["devices"] == 256
    for key in ("memory", "cost", "collectives", "corrected", "roofline", "useful_flop_ratio"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "total_per_device_gib"}
    assert rec["kernels"] == {"fused_decode_matmul/wgmma": 7 * get_config(arch).n_layers}
    assert rec["collectives"]["per_device_bytes"] > 0
    assert 0 < rec["useful_flop_ratio"] <= 1.5

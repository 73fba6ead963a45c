"""Convert decoder-LM parameters to packed ELP_BSD for serving.

The conversion is the paper's Sec. V methodology per stacked layer slice:
one scale factor ``SF = max|W| / 2^max_shift`` per ``[K, N]`` slice,
nearest-level quantization, and Algorithm 1 over the contracting rows of
each (slice, column). It runs through the port's conversion engine
(:mod:`repro_torch.core.convert`) one slice at a time: with per-slice
scale factors and per-(slice, column) groups nothing couples two slices,
so the stacked result is the JAX package's stacked call code for code,
while only one slice's float32 copy and its sort and rank temporaries sit
on the device (a full-width qwen3-8b ``w1`` stack is ``[36, 4096, 12288]``,
7.2 GB in float32).

What gets encoded: the matmul leaves named in :data:`QUANTIZABLE`, the
MoE expert stacks ``we1``/``we3``/``we2`` ``[L, E, K, N]`` among them (one
scale factor per ``[K, N]`` slice). Embeddings, the LM head, routers,
norms and biases stay in the model dtype.
The JAX package's deprecated ``quantize_params_for_serving`` is kept as a
wrapper: :func:`repro_torch.api.quantize` is the entry point.
"""
from __future__ import annotations

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.kernels.ops import PackedWeight, pack_weight, packed_tree_bytes

# Leaf names whose trailing [K, N] dims are matmul weights to encode.
QUANTIZABLE = {
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "xq", "xk", "xv", "xo",
    "in_proj", "out_proj", "w_gate", "w_rec", "w_out", "frontend_proj",
    "we1", "we2", "we3",
}

# Which calibration tap site measures each matmul leaf's input
# (transformer.forward's collection sites). Leaves without a measured
# site are served without static activation quantization.
ACT_SITE_BY_LEAF = {
    "wq": "attn_in", "wk": "attn_in", "wv": "attn_in",
    "wo": "attn_mix",
    "w1": "ffn_in", "w3": "ffn_in", "we1": "ffn_in", "we3": "ffn_in",
    "w2": "ffn_hidden", "we2": "ffn_hidden",
}


def quantize_stacked(
    w: torch.Tensor, fmt: ElpBsdFormat, *, compensate: bool = True, nibble: bool | None = None
) -> PackedWeight:
    """Encode ``w[..., K, N]`` with one scale factor per ``[K, N]`` slice.

    Takes one ``[K, N]`` matrix, a layer stack ``[L, K, N]`` or an MoE
    expert stack ``[L, E, K, N]``. Encodes slice by slice into preallocated
    stacked codes ``[..., K', N]`` and scale factors ``[..., 1, 1]``,
    identical to converting the whole stack at once at
    ``granularity="per_slice"`` (Algorithm 1 groups the contracting rows of
    each slice's columns, so no two slices interact).
    """
    if w.ndim == 2:
        return pack_weight(w.to(torch.float32), fmt, compensate=compensate,
                           granularity="per_slice", nibble=nibble)[0]
    if w.ndim not in (3, 4):
        raise ValueError(f"quantize_stacked takes [K, N], [L, K, N] or [L, E, K, N]; "
                         f"got {tuple(w.shape)}")
    lead = w.shape[:-2]
    slices = w.reshape(-1, *w.shape[-2:])
    codes = sf = first = None
    for i in range(slices.shape[0]):
        pw, _ = pack_weight(slices[i].to(torch.float32), fmt, compensate=compensate,
                            granularity="per_slice", nibble=nibble)
        if codes is None:
            first = pw
            codes = torch.empty((slices.shape[0], *pw.codes.shape), dtype=torch.uint8,
                                device=w.device)
            sf = torch.empty((slices.shape[0], 1, 1), dtype=torch.float32, device=w.device)
        codes[i] = pw.codes
        sf[i] = pw.sf.reshape(1, 1)
    return PackedWeight(codes=codes.reshape(*lead, *codes.shape[1:]), sf=sf.reshape(*lead, 1, 1),
                        fmt_name=first.fmt_name, nibble=first.nibble, shape=first.shape)


def quantize_params_for_serving(params: dict, cfg, fmt, *, compensate: bool = True,
                                calib=None) -> dict:
    """Deprecated wrapper: every quantizable matmul leaf replaced by a stacked
    PackedWeight (:func:`repro_torch.api_schemes.pack_lm_params`).

    Use :func:`repro_torch.api.quantize`, which drives the same packing walk
    from a ``QuantScheme`` and returns a servable, saveable ``QuantizedModel``.
    """
    import warnings

    from repro_torch.api_schemes import pack_lm_params
    from repro_torch.core.elp_bsd import resolve_format

    warnings.warn("runtime.quantized_params.quantize_params_for_serving is deprecated; "
                  "use repro_torch.api.quantize", DeprecationWarning, stacklevel=2)
    return pack_lm_params(params, cfg, resolve_format(fmt), compensate=compensate, calib=calib)


def packed_bytes(params) -> int:
    """Total weight bytes of a (possibly partially) packed tree."""
    return packed_tree_bytes(params)

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

What gets encoded: the matmul leaves named in :data:`QUANTIZABLE`.
Embeddings, the LM head, norms and biases stay in the model dtype.
The JAX package's deprecated ``quantize_params_for_serving`` is not
ported: :func:`repro_torch.api.quantize` is the entry point.
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
    """Encode ``w[L, K, N]`` (or one ``[K, N]``) with one scale factor per slice.

    Encodes slice by slice into preallocated stacked codes ``[L, K', N]``
    and scale factors ``[L, 1, 1]``, identical to converting the whole
    stack at once at ``granularity="per_slice"``.
    """
    if w.ndim == 2:
        return pack_weight(w.to(torch.float32), fmt, compensate=compensate,
                           granularity="per_slice", nibble=nibble)[0]
    if w.ndim != 3:
        raise ValueError(f"quantize_stacked takes [L, K, N] or [K, N]; got {tuple(w.shape)}")
    codes = sf = first = None
    for i in range(w.shape[0]):
        pw, _ = pack_weight(w[i].to(torch.float32), fmt, compensate=compensate,
                            granularity="per_slice", nibble=nibble)
        if codes is None:
            first = pw
            codes = torch.empty((w.shape[0], *pw.codes.shape), dtype=torch.uint8, device=w.device)
            sf = torch.empty((w.shape[0], 1, 1), dtype=torch.float32, device=w.device)
        codes[i] = pw.codes
        sf[i] = pw.sf.reshape(1, 1)
    return PackedWeight(codes=codes, sf=sf, fmt_name=first.fmt_name, nibble=first.nibble,
                        shape=first.shape)


def packed_bytes(params) -> int:
    """Total weight bytes of a (possibly partially) packed tree."""
    return packed_tree_bytes(params)

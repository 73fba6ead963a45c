"""CoNLoCNN core: the ELP_BSD formats, quantization, Algorithm 1, the conversion
engine and the Table II energy model, with the JAX package's ``repro.core``
public names but one: the deprecated ``methodology.convert`` is not re-exported,
since here it would hide the :mod:`repro_torch.core.convert` submodule."""
from repro_torch.core.elp_bsd import (
    DigitSpec,
    ElpBsdFormat,
    FORMAT_A,
    FORMAT_ALIASES,
    FORMAT_B,
    FORMAT_C,
    FORMAT_D,
    PRESET_FORMATS,
    TABLE2_FORMATS,
    resolve_format,
    decode_codes,
    encode_to_codes,
    pack_codes,
    storage_bytes,
    unpack_codes,
)
from repro_torch.core.convert import (
    ConvertedTensor,
    bitpack,
    convert_tensor,
    default_group_axes,
    nibble_pack,
    sf_reduce_axes,
)
from repro_torch.core.quantize import (
    QuantizedTensor,
    ca_levels,
    fake_quant_dynamic,
    fake_quant_uniform,
    nn_quantize,
    nn_quantize_idx,
    quantize_tensor,
    scale_factor,
    tql,
    uniform_levels,
)
from repro_torch.core.compensate import (
    compensate_groups,
    compensate_tensor,
    compensated_quantize,
    mean_error_report,
)
from repro_torch.core.energy import network_energy_nj, pdp_fj, pdp_reduction
from repro_torch.core.methodology import (
    ConversionResult,
    find_critical_act_bits,
    quantize_model,
    run_methodology,
)

__all__ = [k for k in dir() if not k.startswith("_")]

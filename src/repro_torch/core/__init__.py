"""Format tables, quantization primitives, Algorithm 1 and the conversion engine."""

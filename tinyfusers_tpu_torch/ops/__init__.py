from .activations import (gelu_erf, gelu_tanh, geglu, quick_gelu, rounded_to, sigmoid, silu,
                          swish)
from .attention import packed_beneficial, sdpa, sdpa_math, sdpa_packed
from .conv import conv2d, upsample_nearest_2x
from .embedding import embedding
from .linear import geglu_linear, linear
from .norms import group_norm, layer_norm
from .rope import apply_rope, rope_table
from .quant import (Int4Tensor, QuantizedTensor, dequantize, is_quantized, quantize,
                    quantize_int4)

__all__ = [
    "gelu_erf", "gelu_tanh", "geglu", "quick_gelu", "rounded_to", "sigmoid", "silu", "swish",
    "packed_beneficial", "sdpa", "sdpa_math", "sdpa_packed",
    "conv2d", "upsample_nearest_2x",
    "embedding",
    "geglu_linear", "linear",
    "group_norm", "layer_norm",
    "apply_rope", "rope_table",
    "Int4Tensor", "QuantizedTensor", "dequantize", "is_quantized", "quantize",
    "quantize_int4",
]

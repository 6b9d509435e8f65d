from .activations import gelu_erf, gelu_tanh, geglu, quick_gelu, sigmoid, silu, swish
from .attention import sdpa, sdpa_math, sdpa_packed
from .conv import conv2d, upsample_nearest_2x
from .embedding import embedding
from .linear import geglu_linear, linear
from .norms import group_norm, layer_norm

__all__ = [
    "gelu_erf", "gelu_tanh", "geglu", "quick_gelu", "sigmoid", "silu", "swish",
    "sdpa", "sdpa_math", "sdpa_packed",
    "conv2d", "upsample_nearest_2x",
    "embedding",
    "geglu_linear", "linear",
    "group_norm", "layer_norm",
]

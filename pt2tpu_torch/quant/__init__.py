from .gptq import TernaryLayerQuant, dequantize_layer, quantize_layer_weights, ternary_gptq
from .hessian import HessianAccumulator, accumulate_hessian, damped_inverse
from .pipeline import QuantConfig, quantize_linear, quantize_model

__all__ = [
    "TernaryLayerQuant",
    "dequantize_layer",
    "quantize_layer_weights",
    "ternary_gptq",
    "HessianAccumulator",
    "accumulate_hessian",
    "damped_inverse",
    "QuantConfig",
    "quantize_linear",
    "quantize_model",
]

from .calibration import get_calibration_data, get_token_stream, sample_calibration_windows
from .evaluate import evaluate_perplexity, window_nll

__all__ = [
    "get_calibration_data",
    "get_token_stream",
    "sample_calibration_windows",
    "evaluate_perplexity",
    "window_nll",
]

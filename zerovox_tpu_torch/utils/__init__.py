"""Utilities: debug capture, profiling, checkpoint conversion, the compile cache."""

from .compile_cache import enable_compile_cache
from .convert import convert_checkpoint, convert_state_dict, fold_weight_norm
from .debug import capture_run, print_taps, summarize, tap
from .profiling import device_time, trace

__all__ = ["tap", "capture_run", "summarize", "print_taps",
           "device_time", "trace",
           "convert_checkpoint", "convert_state_dict", "fold_weight_norm",
           "enable_compile_cache"]

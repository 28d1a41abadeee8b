from .stft import (
    STFTConfig,
    make_window,
    padded_window,
    ola_window_sq_sum,
    frame_signal,
    overlap_add,
    stft,
    istft,
    compress,
    uncompress,
    compressed_stft,
    compressed_istft,
    init_stft_carry,
    init_istft_carry,
    stft_streaming_step,
    istft_streaming_step,
)

__all__ = [
    "STFTConfig", "make_window", "padded_window", "ola_window_sq_sum",
    "frame_signal", "overlap_add", "stft", "istft", "compress", "uncompress",
    "compressed_stft", "compressed_istft", "init_stft_carry",
    "init_istft_carry", "stft_streaming_step", "istft_streaming_step",
]

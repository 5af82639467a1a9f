"""kernel.mrf_roofline.card (%): layer Kernel; moves card_ms_per_audio_s.
The same reading as kernel.mrf_roofline (the MRF stage calls' least time
over the MRF kernels' device time in the traced sub-window), for the cells
whose end-to-end cost is the card's time per second of speech."""

from benchmark import spec

read = spec.reader("metrics", "kernel.mrf_roofline")

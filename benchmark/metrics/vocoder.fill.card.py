"""vocoder.fill.card (%): layer Vocoder; moves card_ms_per_audio_s.  The same
reading as vocoder.fill (frames needed over frames vocoded in the traced
sub-window), for the cells whose end-to-end cost is the card's time per
second of speech: the batcher vocodes each dispatch at the bucket of its
longest row, with the rows padded to a batch size of the engine's ladder, so
what it vocodes past the frames its requests need is card time spent on no
speech."""

from benchmark import spec

read = spec.reader("metrics", "vocoder.fill")

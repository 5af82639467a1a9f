"""Serving runtime: the single-device TTSEngine and utterance parsing."""

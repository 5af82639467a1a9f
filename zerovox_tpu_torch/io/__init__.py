"""Checkpoint (GGUF) and audio (WAV) I/O."""

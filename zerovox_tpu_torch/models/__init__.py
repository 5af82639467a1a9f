"""The three TTS stages and the end-to-end pipeline."""

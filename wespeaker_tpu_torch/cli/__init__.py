"""The one-shot Speaker API (`speaker.py`): counterpart of
wespeaker_tpu/cli, local model directories only."""

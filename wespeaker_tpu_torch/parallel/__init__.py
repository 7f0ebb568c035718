"""Data and model parallelism over process groups (counterpart of
wespeaker_tpu/parallel/)."""

"""Speaker diarization: counterpart of wespeaker_tpu/diar (SAD, sliding-window
subsegments, spectral and UMAP+HDBSCAN clustering, RTTM and DER)."""

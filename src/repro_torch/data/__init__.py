"""The training data pipeline (``pipeline.TokenPipeline``: FMBI-sharded
synthetic token batches)."""

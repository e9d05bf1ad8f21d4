"""Training: the long-context doc model's trainer on one card (documents,
the train step, the loop's shared pieces, metrics, calibration,
checkpoints and the pipeline that packages and registers a doc bundle)."""

"""Training on one card: the exact tier's dense trainer (``loop.fit``,
``pipeline.run_training``), masked-feature pretraining of the BERT trunk
(``pretrain``) and the long-context doc model's trainer, with what they
share (the loss, the optimizer, metrics, calibration, checkpoints) and
the pipeline that packages and registers a bundle."""

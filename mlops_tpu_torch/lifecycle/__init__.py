"""Lifecycle: the closed MLOps loop, the JAX package's ``lifecycle/``.

Threshold policies over the device-resident monitor aggregates
(``triggers``), an off-hot-path incremental retrain fed by a bounded
on-disk sample reservoir (``retrain``), a shadow engine that captures the
candidate's serving programs and mirrors live traffic (``shadow``), and
gated zero-downtime promotion with instant rollback (``promote``),
orchestrated by ``controller.LifecycleController``, which ``serve`` runs
when ``lifecycle.enabled=true`` (in the single-process server, or in the
ring plane's engine process) and the ``lifecycle`` command drives as a
one-shot offline pass. The quant student's packaging-time gate
(``promote.quant_tier_gates``) lives here too.

This ``__init__`` imports nothing, so the training path's import of
``promote.quant_tier_gates`` loads no serving engine.
"""

"""Synthetic credit-default data generator.

The reference trains on an adapted UCI Credit Card Default CSV
(`databricks/data/curated.csv`, referenced at
`.github/workflows/deploy-infrastructure.yml:195-198` but stripped from the
mount) and ships an 80-row `databricks/data/inference.csv` sample. This module
generates schema-conforming data with a known generative process so training,
HPO, drift, and benchmarks are reproducible without the original dataset.

The generative process encodes real credit-risk structure so learned models
have signal to find: a latent delinquency trait drives repayment-status
categories, payment-to-bill ratios, and the default probability; utilization
(bill/credit-limit) and demographics modulate it.

A copy of the JAX package's ``data/synth.py`` (numpy only): the same seed
gives the same rows in both packages.
"""

from __future__ import annotations

import numpy as np

from mlops_tpu_torch.schema.features import SCHEMA, _REPAYMENT_VOCAB


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def generate_synthetic(
    n: int,
    seed: int = 0,
    drift: float = 0.0,
) -> tuple[dict[str, list], np.ndarray]:
    """Generate ``n`` rows of schema-conforming data.

    Args:
      n: number of rows.
      seed: RNG seed.
      drift: 0.0 for in-distribution data; larger values shift the
        distributions (used to test drift detection, parity with
        alibi-detect's semantics in `02-register-model.ipynb:225-230`).

    Returns:
      (columns, labels) where ``columns`` maps feature name -> list of python
      values (str for categorical, float for numeric) and ``labels`` is an
      int8 array of default indicators.
    """
    rng = np.random.default_rng(seed)

    # Latent delinquency trait in [0, 1]: most customers low, a tail high.
    delinquency = rng.beta(1.2 + drift * 2.0, 4.0, size=n)

    age = np.clip(rng.normal(37.0 + 8.0 * drift, 9.5, size=n), 21.0, 79.0)

    education_p = np.array([0.38, 0.42, 0.17, 0.03])
    education = rng.choice(len(education_p), size=n, p=education_p)
    sex = rng.choice(2, size=n, p=[0.45, 0.55])
    marriage_p = np.array([0.45, 0.52, 0.03])
    marriage = rng.choice(len(marriage_p), size=n, p=marriage_p)

    # Credit limit: lognormal, higher for more educated / older, in dollars.
    limit_mu = 9.4 + 0.25 * (education == 0) - 0.15 * (education == 2) + 0.004 * age
    credit_limit = np.exp(rng.normal(limit_mu, 0.55 + 0.2 * drift))
    credit_limit = np.round(np.clip(credit_limit, 1000.0, 300000.0), -2)

    # Repayment statuses: delinquency trait -> delay months (0..9 mapped onto
    # vocab: duly_paid, no_delay, delay_1..9). AR(1)-ish persistence month to
    # month.
    n_levels = len(_REPAYMENT_VOCAB)
    base_level = np.clip(
        rng.poisson(delinquency * 3.2) + (delinquency > 0.6).astype(int),
        0,
        n_levels - 1,
    )
    repayment = np.zeros((6, n), dtype=np.int64)
    level = base_level
    for month in range(6):
        step = rng.integers(-1, 2, size=n)
        level = np.clip(level + step * (rng.random(n) < 0.35), 0, n_levels - 1)
        repayment[month] = level

    # Utilization and bills: delinquent customers carry higher balances.
    utilization = np.clip(
        rng.beta(2.0, 5.0, size=n) + 0.5 * delinquency + 0.2 * drift, 0.0, 1.5
    )
    bills = np.empty((6, n))
    bill = utilization * credit_limit * rng.uniform(0.7, 1.1, size=n)
    for month in range(6):
        bill = np.clip(
            bill * rng.uniform(0.85, 1.15, size=n)
            + rng.normal(0, 0.02, size=n) * credit_limit,
            0.0,
            None,
        )
        bills[month] = np.round(bill, 2)

    # Payments: fraction of the bill, lower for delinquent customers.
    pay_frac = np.clip(
        rng.beta(3.0, 2.0, size=n) * (1.0 - 0.8 * delinquency), 0.0, 1.0
    )
    payments = np.round(
        bills * pay_frac * rng.uniform(0.6, 1.0, size=(6, n)), 2
    )

    # Default probability: driven by delinquency, utilization, payment ratio.
    payment_ratio = payments.sum(0) / np.maximum(bills.sum(0), 1.0)
    logit = (
        -3.6
        + 7.0 * delinquency
        + 2.0 * np.clip(utilization, 0, 1.2)
        - 2.6 * payment_ratio
        + 0.5 * (repayment[0] >= 3)
        - 0.02 * (age - 37.0)
    )
    labels = (rng.random(n) < _sigmoid(logit)).astype(np.int8)

    edu_vocab = SCHEMA.categorical[1].vocab
    mar_vocab = SCHEMA.categorical[2].vocab
    sex_vocab = SCHEMA.categorical[0].vocab

    columns: dict[str, list] = {
        "sex": [sex_vocab[i] for i in sex],
        "education": [edu_vocab[i] for i in education],
        "marriage": [mar_vocab[i] for i in marriage],
    }
    for month in range(6):
        columns[f"repayment_status_{month + 1}"] = [
            _REPAYMENT_VOCAB[i] for i in repayment[month]
        ]
    columns["credit_limit"] = credit_limit.tolist()
    columns["age"] = np.round(age, 1).tolist()
    for month in range(6):
        columns[f"bill_amount_{month + 1}"] = bills[month].tolist()
    for month in range(6):
        columns[f"payment_amount_{month + 1}"] = payments[month].tolist()

    return columns, labels

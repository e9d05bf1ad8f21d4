"""Two-sample drift statistics (port of the JAX package's ``ops/drift.py``).

- categorical features -> chi-squared contingency test on a 2 x K table,
  categories absent from both samples dropped;
- numeric features -> two-sample Kolmogorov-Smirnov, asymptotic p-value
  with the Stephens small-sample correction.

Every function is written over leading batch dimensions (features, request
slots), which stand in for the JAX package's ``vmap``. All arithmetic is
f32, as in the reference.
"""

from __future__ import annotations

import math

import torch


def chi2_two_sample(
    ref_counts: torch.Tensor,  # f32 [..., K] category counts from training
    batch_counts: torch.Tensor,  # f32 [..., K] category counts from the batch
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chi-squared test with empty-cell masking -> ``(statistic, p_value)``
    over the leading dimensions. A batch with no rows gives NaN (the
    expected counts divide by zero) — the accumulator folds select it
    away."""
    ref_counts = ref_counts.float()
    batch_counts = batch_counts.float()
    col_total = ref_counts + batch_counts
    valid = col_total > 0
    n_ref = ref_counts.sum(dim=-1, keepdim=True)
    n_batch = batch_counts.sum(dim=-1, keepdim=True)
    grand = torch.clamp(n_ref + n_batch, min=1.0)

    expected_ref = n_ref * col_total / grand
    expected_batch = n_batch * col_total / grand
    one = torch.ones_like(expected_ref)
    zero = torch.zeros_like(expected_ref)
    safe_ref = torch.where(valid, expected_ref, one)
    safe_batch = torch.where(valid, expected_batch, one)
    stat = torch.where(
        valid, (ref_counts - expected_ref) ** 2 / safe_ref, zero
    ).sum(dim=-1) + torch.where(
        valid, (batch_counts - expected_batch) ** 2 / safe_batch, zero
    ).sum(dim=-1)
    df = torch.clamp(valid.sum(dim=-1) - 1, min=1).float()
    # chi2 survival function: Q(df/2, stat/2), the regularized upper
    # incomplete gamma function.
    p_value = torch.special.gammaincc(df / 2.0, stat / 2.0)
    return stat, p_value


# sqrt(2 pi) in f32, the correctly rounded root either device computes. A
# CPU scalar, so a program on the card that uses it uploads nothing (a
# host-to-device copy cannot be captured into a CUDA graph).
_ROOT_TWO_PI = torch.sqrt(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _kolmogorov_sf(t: torch.Tensor, terms: int = 32) -> torch.Tensor:
    """Kolmogorov distribution survival function Q(t), elementwise.

    The alternating series ``2*sum (-1)^{k-1} e^{-2k^2 t^2}`` for large
    ``t``; the Jacobi-theta dual form
    ``1 - sqrt(2*pi)/t * sum e^{-(2k-1)^2 pi^2 / (8 t^2)}`` below 1, where
    the series converges too slowly."""
    t_safe = torch.clamp(t.float(), min=1e-8)[..., None]
    k = torch.arange(1, terms + 1, dtype=torch.float32, device=t.device)
    signs = torch.where(k % 2 == 1, 1.0, -1.0)
    large = 2.0 * (signs * torch.exp(-2.0 * (k**2) * (t_safe**2))).sum(dim=-1)
    odd = 2.0 * k - 1.0
    small = 1.0 - _ROOT_TWO_PI / t_safe[..., 0] * torch.exp(
        -(odd**2) * (math.pi**2) / (8.0 * t_safe**2)
    ).sum(dim=-1)
    return torch.clamp(
        torch.where(t_safe[..., 0] < 1.0, small, large), 0.0, 1.0
    )


def ks_small_masked_statistic(
    ref_sorted: torch.Tensor,  # f32 [..., R] ascending
    ref_cdf: torch.Tensor,  # f32 [..., R] ECDF_ref at its own points
    batch: torch.Tensor,  # f32 [..., B] possibly padded
    mask: torch.Tensor,  # bool [..., B] True for real rows
) -> torch.Tensor:
    """The dense masked K-S statistic over the leading dimensions.

    The supremum of |ECDF_ref - ECDF_batch| over the pooled points splits
    into batch points ([B,R] and [B,B] comparison planes) and reference
    points ([R,B], with ECDF_ref there a fit-time constant). Padding rows
    are +inf and count nowhere. Counts are integers and each division is
    one correctly rounded f32 division, so the statistic is exact."""
    r = ref_sorted.shape[-1]
    ref_sorted = ref_sorted.float()
    inf = torch.full_like(batch, float("inf"), dtype=torch.float32)
    bvals = torch.where(mask, batch.float(), inf)
    n_valid = torch.clamp(mask.sum(dim=-1).float(), min=1.0)[..., None]

    # ECDFs at batch points.
    cnt_ref = (ref_sorted[..., None, :] <= bvals[..., :, None]).sum(dim=-1)
    f_ref_b = cnt_ref.float() / r
    cnt_b = (bvals[..., None, :] <= bvals[..., :, None]).sum(dim=-1).float()
    f_b_b = torch.minimum(cnt_b, n_valid) / n_valid
    d_b = torch.where(
        torch.isfinite(bvals),
        (f_ref_b - f_b_b).abs(),
        torch.zeros_like(f_ref_b),
    ).amax(dim=-1)

    # ECDFs at reference points.
    cnt_r = (bvals[..., None, :] <= ref_sorted[..., :, None]).sum(dim=-1)
    f_b_r = torch.minimum(cnt_r.float(), n_valid) / n_valid
    d_r = (ref_cdf.float() - f_b_r).abs().amax(dim=-1)

    stat = torch.maximum(d_b, d_r)
    return torch.where(mask.any(dim=-1), stat, torch.zeros_like(stat))



def _ks_p_value(statistic: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Asymptotic p-value with the Stephens correction (scipy's
    two-sample ``method="asymp"``)."""
    return _kolmogorov_sf((en + 0.12 + 0.11 / en) * statistic)


def _pooled_cdfs(
    ref_sorted: torch.Tensor, batch_sorted: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pooled points (reference ‖ sorted batch) and each sample's
    right-continuous count at them, by ``searchsorted(side="right")`` over
    the leading dimensions."""
    lead = batch_sorted.shape[:-1]
    ref = ref_sorted.float().expand(*lead, ref_sorted.shape[-1]).contiguous()
    pooled = torch.cat([ref, batch_sorted], dim=-1)
    ref_counts = torch.searchsorted(ref, pooled, right=True)
    batch_counts = torch.searchsorted(batch_sorted.contiguous(), pooled, right=True)
    return pooled, ref_counts, batch_counts


def ks_two_sample(
    ref_sorted: torch.Tensor,  # f32 [..., R] ascending
    batch: torch.Tensor,  # f32 [..., B] unsorted
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-sample K-S over the leading dimensions -> ``(statistic,
    p_value)``: both right-continuous ECDFs at every pooled sample point
    (tie-safe), counts by ``searchsorted`` over the sorted batch, each
    ECDF one correctly rounded f32 division."""
    r, b = ref_sorted.shape[-1], batch.shape[-1]
    batch_sorted = torch.sort(batch.float(), dim=-1).values
    _, ref_counts, batch_counts = _pooled_cdfs(ref_sorted, batch_sorted)
    statistic = (ref_counts.float() / r - batch_counts.float() / b).abs().amax(dim=-1)
    en = torch.sqrt(
        torch.tensor(r * b, dtype=torch.float32, device=batch.device)
        / torch.tensor(r + b, dtype=torch.float32, device=batch.device)
    )
    return statistic, _ks_p_value(statistic, en)


def ks_two_sample_small_masked(
    ref_sorted: torch.Tensor,  # f32 [..., R] ascending
    ref_cdf: torch.Tensor,  # f32 [..., R]
    batch: torch.Tensor,  # f32 [..., B] possibly padded, B small
    mask: torch.Tensor,  # bool [..., B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """K-S for small padded batches as dense comparisons
    (``ks_small_masked_statistic``) with its p-value over the valid
    rows."""
    r = ref_sorted.shape[-1]
    statistic = ks_small_masked_statistic(ref_sorted, ref_cdf, batch, mask)
    n_valid = torch.clamp(mask.sum(dim=-1).float(), min=1.0)
    en = torch.sqrt(r * n_valid / (r + n_valid))
    return statistic, _ks_p_value(statistic, en)


def ks_two_sample_masked(
    ref_sorted: torch.Tensor,  # f32 [..., R] ascending
    batch: torch.Tensor,  # f32 [..., B] possibly padded
    mask: torch.Tensor,  # bool [..., B] True for real rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """K-S ignoring padded rows, by sort and ``searchsorted``: padding is
    +inf (it sorts to the tail), the batch ECDF divides by the valid rows,
    and only finite pooled points count, so the statistic is the unpadded
    batch's. An all-padding batch gives 0."""
    r = ref_sorted.shape[-1]
    inf = torch.full_like(batch, float("inf"), dtype=torch.float32)
    bvals = torch.where(mask, batch.float(), inf)
    batch_sorted = torch.sort(bvals, dim=-1).values
    n_valid = torch.clamp(mask.sum(dim=-1).float(), min=1.0)[..., None]
    pooled, ref_counts, batch_counts = _pooled_cdfs(ref_sorted, batch_sorted)
    ref_f = ref_counts.float() / r
    batch_f = torch.minimum(batch_counts.float(), n_valid) / n_valid
    diff = torch.where(
        torch.isfinite(pooled), (ref_f - batch_f).abs(), torch.zeros_like(ref_f)
    )
    statistic = diff.amax(dim=-1)
    statistic = torch.where(mask.any(dim=-1), statistic, torch.zeros_like(statistic))
    n = n_valid[..., 0]
    en = torch.sqrt(r * n / (r + n))
    return statistic, _ks_p_value(statistic, en)

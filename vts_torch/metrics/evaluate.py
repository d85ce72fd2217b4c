"""Evaluation metric names (``vts_tpu/metrics/evaluate.py``).  The batched
evaluation itself is :mod:`vts_torch.metrics.evaluate_batch`; the legacy
per-metric loop of the reference is not ported yet."""

DEFAULT_EVAL_METRICS = (
    "I_SIFID", "I_LPIPS", "I_PSNR", "I_SSIM",
    "T_SIFID", "T_LPIPS", "T_AE", "T_MSE",
)

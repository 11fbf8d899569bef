"""FLOPs and MFU accounting (the port's copy of ``autodist_tpu/utils/flops.py:75-119``,
with the peak of the port's card)."""

from typing import Optional

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet, at the full 700 W).
H100_PEAK_BF16_FLOPS = 989e12


def transformer_flops_per_token(d_model: int, n_layers: int, d_ff: int,
                                vocab_size: int, seq_len: int,
                                n_experts_active: int = 1) -> float:
    """Analytic training FLOPs per token for a decoder LM: per layer ``8 d^2``
    attention projections, ``4 s d`` score/value matmuls and ``4 d d_ff`` MLP
    (times the active experts), plus the ``2 d V`` vocab head; training is 3x
    the forward. The full score matrix is counted, as the JAX package counts
    it; the port's causal flash kernels compute only its lower half, so at
    long sequences this overstates the work done."""
    per_layer = (8 * d_model * d_model + 4 * seq_len * d_model
                 + 4 * d_model * d_ff * n_experts_active)
    fwd = n_layers * per_layer + 2 * d_model * vocab_size
    return 3.0 * fwd


def mfu(flops_per_sec: Optional[float],
        peak: float = H100_PEAK_BF16_FLOPS) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None when the rate is unknown."""
    if not flops_per_sec:
        return None
    return flops_per_sec / peak


def report_mfu(flops_per_step: Optional[float], steps_per_sec: Optional[float],
               label: str = "mfu") -> Optional[float]:
    """Print the JAX package's MFU line, ``<label> <pct>% (<TFLOP/s>, <GFLOP/step>)``,
    against the H100's peak; returns the MFU fraction. Call it only for a run
    on the card: a CPU rate over the card's peak is no device metric."""
    if not flops_per_step or not steps_per_sec:
        return None
    value = mfu(flops_per_step * steps_per_sec)
    print(f"{label} {100.0 * value:.2f}% "
          f"({flops_per_step * steps_per_sec / 1e12:.1f} TFLOP/s, "
          f"{flops_per_step / 1e9:.2f} GFLOP/step)")
    return value

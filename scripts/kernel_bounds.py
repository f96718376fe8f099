"""Least time an NVIDIA H100 SXM could take for each TPU kernel's work.

    python scripts/kernel_bounds.py

For every function of the JAX package that reaches ``pl.pallas_call``
(numbered as in PERF.md's kernel table), the operations and bytes its
function needs at the flagship shapes with B = 2 (64×128 tokens a sample,
dim 1056, 12 heads × 88, SwiGLU hidden 2816, 16×16 windows), and the bound
max(operations / peak rate, bytes / 3.35 TB/s): each input read once and
each output written once, bf16 activations and weights, bf16 dense tensor
cores at 989 TFLOP/s and int8 at 1979 TOP/s. The window-tiled kernels (15–17)
and the per-(window, head) kernels (21–22) compute the functions of
kernels 2, 6 and 7 for other grids and layouts, so their work at the
flagship shapes is the same. A second table gives the rows the 0.25°
configuration runs (10, 15–17) at its shapes: B = 1, 368×720 tokens (the
721×1440 grid edge-padded to 736 rows, patch 2), 8 heads × 128. Pure
arithmetic: no device is needed, and ``chip_smoke.py`` computes the same
bounds for the kernels it runs.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "int8": 1979e12}
HBM = 3.35e12

B, TOKENS, D, H, HEADS, HD, WIN = 2, 64 * 128, 1056, 2816, 12, 88, 256
T, INNER = B * TOKENS, HEADS * HD
QUARTER_T, QUARTER_INNER = 368 * 720, 8 * 128  # B = 1 at 0.25°
MB = 1e6


def act(width: int, itemsize: int = 2, tokens: int = T) -> float:
    """Bytes of one (tokens, width) activation."""
    return tokens * width * itemsize


def attention(matmuls: int, inputs: int, outputs: int, tokens: int = T, inner: int = INNER):
    """Window attention with ``matmuls`` (n×n×d) products a window and head;
    ``inputs``/``outputs`` in units of a (tokens, heads·d) bf16 activation."""
    return matmuls * 2 * tokens * WIN * inner, (inputs + outputs) * act(inner, tokens=tokens)


def ffn(matmuls: int, act_in: int, act_out: int, gu_io: int = 0, weights: float = 1.0,
        tokens: int = T):
    """SwiGLU work: ``matmuls`` (tokens×D×H) products, (tokens, D) activations
    in and out, (tokens, H) gate/up tensors read or written, the weights
    ``weights`` times (bf16)."""
    w = 3 * D * H * 2 * weights
    return (matmuls * 2 * tokens * D * H,
            (act_in + act_out) * act(D, tokens=tokens) + gu_io * act(H, tokens=tokens) + w)


QUARTER_ROWS = [
    (10, "pallas_ffn.py:293 _ffn_bwd_call", ffn(8, 2, 1, weights=2, tokens=QUARTER_T), "bf16"),
    (15, "pallas_block_attention.py:655 _tiled_fwd_call",
     attention(2, 3, 1, QUARTER_T, QUARTER_INNER), "bf16"),
    (16, "pallas_block_attention.py:743 _tiled_bwd_call",
     attention(5, 4, 3, QUARTER_T, QUARTER_INNER), "bf16"),
    (17, "pallas_block_attention.py:865 _tiled_tangent_call",
     attention(5, 6, 1, QUARTER_T, QUARTER_INNER), "bf16"),
]

ROWS = [
    # (row, TPU kernel, (operations, bytes), peak)
    (1, "pallas_linear.py:36 _lin_call",
     (2 * T * D * 3 * INNER, act(D) + 3 * INNER * D * 2 + act(3 * INNER)), "bf16"),
    (2, "pallas_block_attention.py:264 _fwd_call", attention(2, 3, 1), "bf16"),
    (3, "pallas_modnorm.py:271 _mm_mn_call",
     (2 * T * INNER * D + 10 * T * D, act(INNER) + INNER * D * 2 + 2 * act(D)), "bf16"),
    (4, "pallas_modnorm.py:56 _call", (10 * T * D, 3 * act(D)), "bf16"),
    (5, "pallas_ffn.py:68 _ffn_call", ffn(3, 1, 1), "bf16"),
    (6, "pallas_block_attention.py:291 _bwd_call", attention(5, 4, 3), "bf16"),
    (7, "pallas_block_attention.py:408 _tangent_call", attention(5, 6, 1), "bf16"),
    (8, "pallas_ffn.py:117 _ffn_fwd_save_call", ffn(3, 1, 1, gu_io=2), "bf16"),
    (9, "pallas_ffn.py:199 _ffn_bwd_saved_call", ffn(6, 2, 1, gu_io=2, weights=2), "bf16"),
    (10, "pallas_ffn.py:293 _ffn_bwd_call", ffn(8, 2, 1, weights=2), "bf16"),
    (11, "pallas_ffn.py:392 _ffn_pt_call", ffn(6, 2, 2), "bf16"),
    (12, "pallas_modnorm.py:202 _tangent_call", (18 * T * D, 4 * act(D)), "bf16"),
    (13, "pallas_linear.py:84 _lin_bwd_call",
     (4 * T * D * 3 * INNER, act(3 * INNER) + 2 * act(D) + 2 * 3 * INNER * D * 2), "bf16"),
    (14, "pallas_linear.py:145 _lin_pt_call",
     (4 * T * D * 3 * INNER, 2 * act(D) + 3 * INNER * D * 2 + 2 * act(3 * INNER)), "bf16"),
    (15, "pallas_block_attention.py:655 _tiled_fwd_call", attention(2, 3, 1), "bf16"),
    (16, "pallas_block_attention.py:743 _tiled_bwd_call", attention(5, 4, 3), "bf16"),
    (17, "pallas_block_attention.py:865 _tiled_tangent_call", attention(5, 6, 1), "bf16"),
    (18, "pallas_ffn.py:521 fused_swiglu_ffn_int8", ffn(3, 1, 1, weights=0.5), "int8"),
    (19, "pallas_modnorm.py:366 fused_matmul_modnorm_residual_int8",
     (2 * T * INNER * D, act(INNER) + INNER * D + 2 * act(D)), "int8"),
    (20, "pallas_ffn.py:600 _ffn_mn_call", ffn(3, 2, 1), "bf16"),
    (21, "pallas_attention.py:61 _sdpa_fwd", attention(2, 3, 1), "bf16"),
    (22, "pallas_attention.py:98 _sdpa_bwd_call", attention(5, 4, 3), "bf16"),
    (22, "pallas_attention.py:155 _sdpa_tangent_call", attention(5, 6, 1), "bf16"),
]


def bound(ops: float, nbytes: float, peak: str) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK[peak] * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def table(rows) -> None:
    print(f"{'row':>3}  {'TPU kernel':58s} {'Gop':>8} {'MB':>8} {'bound ms':>9}  by")
    for row, name, (ops, nbytes), peak in rows:
        ms, by = bound(ops, nbytes, peak)
        print(f"{row:3d}  {name:58s} {ops / 1e9:8.1f} {nbytes / MB:8.1f} {ms:9.4f}  {by}"
              + (" (int8 peak)" if peak == "int8" else ""))


def main() -> None:
    print(f"flagship shapes, B = {B}: T = {T} tokens, dim {D}, {HEADS}×{HD} heads, hidden {H}")
    table(ROWS)
    print(f"\n0.25° shapes, B = 1: T = {QUARTER_T} tokens (368×720), dim {D}, 8×128 heads, "
          f"hidden {H}")
    table(QUARTER_ROWS)


if __name__ == "__main__":
    main()

"""The kernel probes (``scripts/probe_*.py``) against the committed CUDA
sources: each variant's text substitutions still match once in the source
it edits, so that a probe's documented default run builds every variant.
No build and no card: the substitutions are made in a temporary copy."""

import importlib

import pytest

from scripts import probe_build

PROBES = ["probe_window_attention", "probe_window_attention_bwd", "probe_attention_fwd", "probe_attention_bwd",
          "probe_attention_tangent", "probe_mm_modnorm", "probe_backward_gemm", "probe_ffn_int8",
          "probe_ffn_bwd_recompute", "probe_mm_modnorm_int8", "probe_modnorm",
          "probe_window_attention_tangent"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_variants_match_the_committed_source(name):
    probe = importlib.import_module(f"scripts.{name}")
    assert "committed" in probe.VARIANTS
    probe_build.check_variants(probe.VARIANTS, probe.SOURCE)

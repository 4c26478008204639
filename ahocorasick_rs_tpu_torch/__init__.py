"""ahocorasick_rs_tpu_torch — multi-pattern string matching in PyTorch and CUDA.

The PyTorch port of ``ahocorasick_rs_tpu``, with the public surface of the
reference ``ahocorasick_rs`` package (upstream
pysrc/ahocorasick_rs/__init__.py:1-23): the automaton is compiled
host-side into dense tables, and large haystacks are scanned on an NVIDIA
GPU by hand-written CUDA kernels (a Teddy prefilter with windowed
verification, or a halo'd lane scan), with host tiers for small inputs.
"""

from .api import AhoCorasick, BytesAhoCorasick
from .models.engine import Implementation, MatchKind
from .utils.serialization import load_matcher, save_matcher

# Backwards compatibility aliases, mirroring the reference
# (upstream pysrc/ahocorasick_rs/__init__.py:9-12).
MATCHKIND_STANDARD = MatchKind.Standard
MATCHKIND_LEFTMOST_FIRST = MatchKind.LeftmostFirst
MATCHKIND_LEFTMOST_LONGEST = MatchKind.LeftmostLongest

__all__ = [
    "AhoCorasick",
    "BytesAhoCorasick",
    "MatchKind",
    "Implementation",
    # Device extras (no reference counterpart):
    "save_matcher",
    "load_matcher",
    # Deprecated:
    "MATCHKIND_STANDARD",
    "MATCHKIND_LEFTMOST_FIRST",
    "MATCHKIND_LEFTMOST_LONGEST",
]

__version__ = "0.1.0"

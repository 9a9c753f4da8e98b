"""video_encoder — a video encode/decode engine in JAX.

Built from scratch in JAX/XLA with the capabilities of the
`arkanis/video-encoder` C pipeline (see SURVEY.md; the reference mount was
empty, so parity targets BASELINE.json's attested feature set): block motion
estimation (full ±16 / diamond SAD), 8×8 integer transform + per-MB
quantization, zigzag + Exp-Golomb entropy coding with a two-pass parallel
bit-pack, bit-exact reconstruction/decode, GOP/tile sharding over a device
mesh with collective reference-frame/halo exchange, and an in-order host mux.
"""

import os as _os

import jax as _jax

__version__ = "0.1.0"

# Persistent XLA compilation cache: GOP programs take seconds to minutes to
# compile. JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set; only
# otherwise does the package name its fixed default, <checkout>/.jax_cache
# (a fixed path, so later processes find what earlier ones cached).
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

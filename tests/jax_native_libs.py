"""The JAX package's native libraries for the port's parity tests.

The JAX loaders (`oramacore_tpu/native/__init__.py`) compile in place
with g++, next to their sources, and remember a failure for the rest of
the process, so test processes that start at once can open a library
another one is still writing. `bind()` compiles the JAX package's own
sources through the port's build, which names each library by a hash
of its source and flags and lets it appear by one rename, and then binds
each with the JAX package's own loader. Call it once per process before
a test that needs the JAX native routes.
"""

from pathlib import Path

import oramacore_tpu.native as jnative
from oramacore_tpu.utils.tokenizer import TextParser
from oramacore_tpu_torch.native import _build

SRC_DIR = Path(jnative.__file__).resolve().parent
# source -> (library path, library, tried) globals and the loader
LOADERS = {
    "tokenizer": ("_LIB", "_lib", "_tried", "load_tokenizer"),
    "hash_encode": ("_HE_LIB", "_he_lib", "_he_tried", "load_hash_encoder"),
    "live_accum": ("_LA_LIB", "_la_lib", "_la_tried", "load_live_accum"),
}

_bound = False


def bind() -> None:
    global _bound
    if _bound:
        return
    for name, (path, lib, tried, loader) in LOADERS.items():
        source = SRC_DIR / f"{name}.cpp"
        out, _ = _build.build(source)
        # the JAX loader rebuilds (in place) a library older than its source
        if out.stat().st_mtime <= source.stat().st_mtime:
            out.touch()
        setattr(jnative, path, str(out))
        setattr(jnative, lib, None)
        setattr(jnative, tried, False)
        assert getattr(jnative, loader)() is not None, \
            f"the JAX package's {name} library did not load from {out}"
    TextParser._native_lib = jnative.load_tokenizer()
    TextParser._native_checked = True
    _bound = True

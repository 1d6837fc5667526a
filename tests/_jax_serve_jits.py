"""Share the JAX package's compiled serving programs across engines.

The reference's ``ServeEngine`` and ``PrefillEngine`` wrap their model
calls in fresh ``jax.jit`` objects per instance, so every engine a test
builds traces and compiles its prefill, decode, splice and chunk programs
again, although engines of one model, depth and page size compute the
same functions.  ``share`` patches both constructors (for the life of a
``pytest.MonkeyPatch``) so that every engine after the first of its kind
takes the first one's jitted callables: the programs, their inputs and
outputs are unchanged; only the compiled executables are reused.

A kind is what the jitted bodies read from their engine: the config, the
window override, ``max_seq`` (prefill), the page size and the paged flag
(splice), and the reference's decode route (decode).
"""
from repro.serve import disagg as jdisagg
from repro.serve import engine as jengine

_ENGINE_JITS = ("_prefill", "_decode", "_insert", "_clear", "_reset_row",
                "_copy_page", "_chunk")


def share(mp):
    cache = {}
    eng_init = jengine.ServeEngine.__init__
    pf_init = jdisagg.PrefillEngine.__init__

    def adopt(obj, key, names):
        first = cache.setdefault(key, {n: getattr(obj, n) for n in names
                                       if hasattr(obj, n)})
        for n, fn in first.items():
            setattr(obj, n, fn)

    def engine(self, *args, **kw):
        eng_init(self, *args, **kw)
        adopt(self, ("engine", self.cfg, self.max_seq, self.window_override,
                     self.page_size, self.paged, self.decode_kernel),
              _ENGINE_JITS)

    def prefill(self, *args, **kw):
        pf_init(self, *args, **kw)
        adopt(self, ("prefill", self.cfg, self.max_seq,
                     self.window_override), ("_prefill",))

    mp.setattr(jengine.ServeEngine, "__init__", engine)
    mp.setattr(jdisagg.PrefillEngine, "__init__", prefill)
    return cache

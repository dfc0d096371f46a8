"""The port's AI layer (`oramacore_tpu_torch.ai`) held to the JAX
package's, on the CPU.

- Every body of `tests/test_ai_layer.py` (prompts, the LLM client, the
  constraint extractor, RAG-AT, the hooks runtime, the answer and
  autoquery state machines, MCP, tools, system prompts, the embeddings
  selector, retries) and of `tests/test_constraint_extractor.py` (each
  parametrised case) runs against the port: the body gets a copy of its
  module's globals with the port's names in place of the JAX package's,
  and for the time of the case `sys.modules` maps each JAX module a body
  imports to its port counterpart (`port_modules`). The LLM is the
  suite's own scripted mock (`tests/ai_mock.py`, on aiohttp), so the
  port's client talks to a server it did not write.
- The port's `PROMPTS` equal JAX's, key by key, system and user byte for
  byte.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import sys
import types

import pytest

from oramacore_tpu import runtime as jax_runtime
from oramacore_tpu.ai import prompts as jax_prompts
from oramacore_tpu_torch import config as port_config
from oramacore_tpu_torch import read as port_read
from oramacore_tpu_torch import runtime as port_runtime
from oramacore_tpu_torch import types as port_types
from oramacore_tpu_torch.ai import (
    answer,
    autoquery,
    constraint_extractor,
    hooks,
    llms,
    mcp,
    prompts,
    ragat,
    service,
    system_prompts,
    tools,
    training_sets,
)

from . import test_ai_layer as layer_suite
from . import test_constraint_extractor as extractor_suite


def cpu_build_orama(config, **kwargs):
    kwargs.setdefault("device", "cpu")
    return port_runtime.build_orama(config, **kwargs)


def port_modules():
    """JAX module name -> the port module a body gets in its place."""
    rt = types.ModuleType("oramacore_tpu_torch_cpu_runtime")
    rt.build_orama = cpu_build_orama
    rt.Orama = port_runtime.Orama
    out = {"oramacore_tpu.types": port_types,
           "oramacore_tpu.config": port_config,
           "oramacore_tpu.read": port_read,
           "oramacore_tpu.runtime": rt}
    for mod in (answer, autoquery, constraint_extractor, hooks, llms, mcp,
                prompts, ragat, service, system_prompts, tools,
                training_sets):
        out["oramacore_tpu.ai." + mod.__name__.rsplit(".", 1)[1]] = mod
    return out


def port_globals(module):
    """A copy of `module`'s globals with each name it took from a JAX
    module of `port_modules` replaced by the port's, and its helper
    functions rebound to that copy. A name left pointing at the JAX
    package raises."""
    g = dict(vars(module))
    left = set()
    for jax_name, port_mod in port_modules().items():
        jax_mod = sys.modules.get(jax_name)
        if jax_mod is None:
            continue
        for name, value in vars(module).items():
            if name.startswith("__") or name == "annotations":
                continue
            if value is jax_mod:
                g[name] = port_mod
            elif getattr(jax_mod, name, None) is value and \
                    not isinstance(value, types.ModuleType):
                if hasattr(port_mod, name):
                    g[name] = getattr(port_mod, name)
                else:
                    left.add(name)
    left = {n for n in left if g[n] is vars(module)[n]}
    if left:
        raise AssertionError(f"no port counterpart of {sorted(left)}")
    for name, f in list(g.items()):
        if inspect.isfunction(f) and f.__module__ == module.__name__:
            g[name] = rebind(f, g)
    return g


def rebind(f, g):
    """`f` with globals `g`; a wrapper whose closure holds the body (`fn`)
    gets the body rebound too."""
    closure = f.__closure__
    if closure and "fn" in f.__code__.co_freevars:
        inner = closure[f.__code__.co_freevars.index("fn")].cell_contents
        closure = tuple(types.CellType(types.FunctionType(
            inner.__code__, g, inner.__name__, inner.__defaults__,
            inner.__closure__)) if c.cell_contents is inner else c
            for c in closure)
    return types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                              closure)


def _jax_side_reached(*a, **kw):
    raise AssertionError("a port test body reached the JAX package")


def run_on_port(module, name, monkeypatch, **kwargs):
    """Body `name` of `module` against the port: rebound globals, the JAX
    modules it imports mapped to the port's, the JAX runtime made to
    fail."""
    body = port_globals(module)[name]
    for mod_name, mod in port_modules().items():
        monkeypatch.setitem(sys.modules, mod_name, mod)
    monkeypatch.setattr(jax_runtime, "build_orama", _jax_side_reached)
    body(**kwargs)


def suite_cases(module):
    """(body name, its keyword arguments) of every test of `module`, one
    per parametrised case."""
    out = []
    for name, f in sorted(vars(module).items()):
        if not (name.startswith("test_") and inspect.isfunction(f)
                and f.__module__ == module.__name__):
            continue
        marks = [m for m in getattr(f, "pytestmark", [])
                 if m.name == "parametrize"]
        axes = []
        for m in marks:
            names = [n.strip() for n in m.args[0].split(",")]
            axes.append([dict(zip(names, v if len(names) > 1 else (v,)))
                         for v in m.args[1]])
        for combo in itertools.product(*axes):
            out.append((name, {k: v for d in combo for k, v in d.items()}))
    return out


def _case_id(case):
    name, kwargs = case
    if not kwargs:
        return name
    return f"{name}[{'-'.join(str(v) for v in kwargs.values())}]"


LAYER = suite_cases(layer_suite)
EXTRACTOR = suite_cases(extractor_suite)


def test_every_body_is_run():
    assert len({n for n, _ in LAYER}) == 23 and len(LAYER) == 23
    assert len({n for n, _ in EXTRACTOR}) == 18
    assert len(EXTRACTOR) == 18 - 2 + len(extractor_suite.NUMERIC_CASES) + 5


def test_port_modules_cover_the_jax_ai_package():
    import os

    import oramacore_tpu.ai as jax_ai

    jax_names = {f[:-3] for f in os.listdir(os.path.dirname(jax_ai.__file__))
                 if f.endswith(".py") and f != "__init__.py"}
    port = {n.rsplit(".", 1)[1] for n in port_modules()
            if n.startswith("oramacore_tpu.ai.")}
    assert jax_names == port | {"accelerator"}
    import oramacore_tpu_torch.ai.accelerator  # noqa: F401


@pytest.mark.parametrize("case", LAYER, ids=_case_id)
def test_ai_layer_on_port(case, monkeypatch):
    name, kwargs = case
    run_on_port(layer_suite, name, monkeypatch, **kwargs)


@pytest.mark.parametrize("case", EXTRACTOR, ids=_case_id)
def test_constraint_extractor_on_port(case, monkeypatch):
    name, kwargs = case
    run_on_port(extractor_suite, name, monkeypatch, **kwargs)


def test_prompts_equal_jax_byte_for_byte():
    assert list(prompts.PROMPTS) == list(jax_prompts.PROMPTS)
    for key, p in jax_prompts.PROMPTS.items():
        q = prompts.PROMPTS[key]
        assert q.system.encode() == p.system.encode(), key
        assert q.user.encode() == p.user.encode(), key
    assert prompts.ALIASES == jax_prompts.ALIASES
    for name in list(jax_prompts.PROMPTS) + list(jax_prompts.ALIASES):
        vars_ = [("query", "q"), ("context", "[1]"), ("question", "?"),
                 ("conversation", "[]")]
        assert prompts.format_prompt(name, vars_) == \
            jax_prompts.format_prompt(name, vars_), name
    with pytest.raises(KeyError):
        prompts.get_prompt("nope")


def test_the_rebinding_reaches_the_port(monkeypatch):
    """A rebound body sees the port's classes, and one that imports a JAX
    AI module inside its body gets the port's."""
    g = port_globals(layer_suite)
    assert g["LLMService"] is llms.LLMService
    assert g["HooksRuntime"] is hooks.HooksRuntime
    assert g["ragat"] is ragat
    assert g["Interaction"] is port_types.Interaction
    assert g["OramacoreConfig"] is port_config.OramacoreConfig
    for mod_name, mod in port_modules().items():
        monkeypatch.setitem(sys.modules, mod_name, mod)
    from oramacore_tpu.ai.answer import AnswerStateMachine

    assert AnswerStateMachine is answer.AnswerStateMachine
    asyncio.run(asyncio.sleep(0))

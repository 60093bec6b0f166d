"""The harness around the renderer: compile cache, device checks, docs."""
import os
import re

import jax
import pytest

from raytracingpbr_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_rules(monkeypatch, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, nothing is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    """Without it, the cache is the fixed, git-ignored <repo>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu(capsys):
    """chip_smoke.py fails before any phase, and prints no result line,
    when JAX finds no GPU."""
    import chip_smoke
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


# A quoted throughput or frame time: a number followed by a rate/time unit.
_RATE = re.compile(r"\d[\d.,]*\s*(?:Msamples/s|Msps|ms/frame|ms/pass|"
                   r"ms/step|s/frame|frames/hour|steps/s)")
_CARD = re.compile(r"(?:NVIDIA|H100)")
_POWER = re.compile(r"\d+(?:\.\d+)?\s*W\b")


@pytest.mark.parametrize("doc", ["README.md", "PERF.md"])
def test_docs_name_the_card_beside_every_rate(doc):
    """Every paragraph or table of README.md and PERF.md that quotes a
    throughput or frame time also names the NVIDIA card and its power
    limit, so no number can pass for a measurement of other hardware."""
    with open(os.path.join(REPO, doc)) as f:
        blocks = re.split(r"\n\s*\n", f.read())
    for block in blocks:
        if _RATE.search(block):
            assert _CARD.search(block) and _POWER.search(block), (
                f"{doc}: rate quoted without card and power limit:\n"
                f"{block[:400]}")

"""The port's autotuner (``kernels/autotune.py``): the JAX package's
``TestAutotune`` (``tests/test_kernels.py``) on the port, plus the cache's
device key, the int4 candidate set by M, and the int4 route's use of a
cached pick and its memo."""

import json

import pytest
import torch

from torchao_tpu_torch.kernels import autotune as at
from torchao_tpu_torch.kernels import int4_matmul as TK


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "cache.json"))
    for env in (at.ENABLE_ENV, TK.VARIANT_ENV, "TORCHAO_TPU_QPARAMS_LAYOUT"):
        monkeypatch.delenv(env, raising=False)
    TK.reset_variant_choices()
    yield
    TK.reset_variant_choices()


def test_cache_roundtrip(monkeypatch):
    monkeypatch.setenv(at.ENABLE_ENV, "1")
    calls = []

    def run(cfg, xi):
        # bn=512 does far less work, so the argmin is robust on any host
        calls.append(cfg)
        y = xi
        for _ in range(1 if cfg["bn"] == 512 else 60):
            y = y @ y
        return y

    x = torch.eye(256)
    cands = [{"bn": 256}, {"bn": 512}]
    assert at.lookup_or_tune("k", (8, 128, 128, 32), cands, run, iters=3, example_x=x) == \
        {"bn": 512}
    n_calls = len(calls)

    # the second lookup hits the JSON cache: nothing is timed again, even
    # with the in-memory cache dropped
    at.reset_cache()
    assert at.lookup_or_tune("k", (8, 128, 128, 32), cands, run, iters=3, example_x=x) == \
        {"bn": 512}
    assert len(calls) == n_calls

    # without example_x and with no entry: the kernel's own rules (None)
    at.reset_cache()
    assert at.lookup_or_tune("k2", (1, 2), cands, run, iters=2) is None


def test_disabled_returns_none():
    out = at.lookup_or_tune("k", (1, 2), [{"bn": 1}], lambda c, x: x, example_x=torch.ones(1))
    assert out is None


def test_cache_key_names_the_device(tmp_path, monkeypatch):
    """Entries are keyed ``kernel|device|shape``; a CPU tensor's device is
    ``cpu``, and an entry for another device is not used."""
    monkeypatch.setenv(at.ENABLE_ENV, "1")
    at.lookup_or_tune("k", (4, 5), [{"a": 1}], lambda c, x: x, iters=1,
                      example_x=torch.ones(1))
    cache = json.loads((tmp_path / "cache.json").read_text())
    assert list(cache) == ["k|cpu|4,5"]
    assert cache["k|cpu|4,5"]["config"] == {"a": 1}
    assert at.device_name(torch.ones(1)) == "cpu"
    (tmp_path / "cache.json").write_text(json.dumps(
        {"k|NVIDIA H100 80GB HBM3|6,7": {"config": {"a": 2}}}))
    at.reset_cache()
    monkeypatch.delenv(at.ENABLE_ENV)
    assert at.lookup_or_tune("k", (6, 7), [{"a": 1}], lambda c, x: x,
                             example_x=torch.ones(1)) is None


@pytest.mark.parametrize("M", [1, 16, 17, 128])
def test_int4_candidates_keep_the_jax_variant_set(M):
    cands = at.int4_matmul_candidates(M, 4096, 4096, 32)
    variants = {c["variant"] for c in cands}
    small = {"batched_int8", "banded"}
    assert variants == {"fused", "group_partial"} | (small if M <= 16 else set())
    # every body's K split is its own plan: one candidate a variant, the
    # variant its only key
    assert all(set(c) == {"variant"} for c in cands)
    assert len(cands) == len(variants)


def test_int4_route_tunes_once_and_honours_the_override(monkeypatch, tmp_path):
    """``int4_linear`` tunes a shape at its first call (here on the CPU's
    plain versions), memoizes the pick, and a later process takes it from
    the cache; ``TORCHAO_TPU_INT4_VARIANT`` wins over the cache."""
    monkeypatch.setenv(at.ENABLE_ENV, "1")
    K, N, g = 512, 128, 32
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen)
    s = (torch.rand((K // g, N), generator=gen) * 0.01).bfloat16()
    x = torch.randn((1, K), generator=gen).bfloat16()
    call = lambda: TK.int4_linear(x, w, s, None, group_size=g, xored=True)
    call()
    (pick,) = TK.variant_choices().values()
    cache = json.loads((tmp_path / "cache.json").read_text())
    (entry,) = cache.values()
    assert len(entry["all_us"]) == len(at.int4_matmul_candidates(1, N, K, g))
    assert pick == TK.choose_body(1, K, g, entry["config"]["variant"])

    monkeypatch.delenv(at.ENABLE_ENV)
    TK.reset_variant_choices()
    call()
    assert list(TK.variant_choices().values()) == [pick]  # from the cache

    monkeypatch.setenv(TK.VARIANT_ENV, "group_partial")
    TK.reset_variant_choices()
    call()
    assert list(TK.variant_choices().values()) == ["group_partial"]


def test_an_older_cache_entry_with_a_split_target_is_read(tmp_path):
    """A cache written when K14's candidates carried a K-split target
    (``target_blocks``) still gives its variant, and the other key is
    ignored."""
    K, N, g = 512, 128, 32
    gen = torch.Generator().manual_seed(3)
    w = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen)
    s = (torch.rand((K // g, N), generator=gen) * 0.01).bfloat16()
    x = torch.randn((1, K), generator=gen).bfloat16()
    key = f"int4_dq_matmul|cpu|1,{N},{K},{g}"
    (tmp_path / "cache.json").write_text(json.dumps(
        {key: {"config": {"variant": "banded", "target_blocks": 2048}, "time_us": 1.0}}))
    at.reset_cache()
    got = TK.int4_linear(x, w, s, None, group_size=g, xored=True)
    assert TK.variant_choices() == {(1, N, K, g, False, "cpu"): "banded_stacked"}
    want = TK.int4_dq_matmul_banded_plain(x, w, s, None, group_size=g, xored=True)
    assert torch.equal(got, want)

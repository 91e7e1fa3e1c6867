"""Sampled decoding in the port against the JAX package, on the CPU.

``repro_torch.serving.prng`` is held to ``jax.random`` exactly: the keys
of ``fold_in``, the bits, the uniforms and the tokens of ``categorical``
over fixed keys (the Gumbel noise, which goes through ``log``, within a
few ulps).  ``req_key`` equals the JAX engine's ``_req_key``, the port's
``_sample`` the JAX engine's (jitted, as the engine runs it), and the
port's engine serves the JAX engine's sampled token streams for
qwen2.5-3b-smoke and mamba2-2.7b-smoke at temperature {0.7, 1.0} x top_k
{0, 5} over both layouts.  A token that differs is reported with its
position and the gap between its two best perturbed scores.  The port's
own invariants: its sampled streams do not change with the chunk schedule
or ``steps_per_sync``, ``top_k=1`` gives the greedy stream, and the
sampling flags reach the engine through ``configs_from_flags`` as in
JAX."""
import argparse
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import config as jax_config  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
    configs_from_flags,
    engine,
    prng,
)

from torch_parity import jax_params  # noqa: E402

KEYS = np.random.default_rng(3).integers(0, 2 ** 32, (4, 6, 2),
                                         dtype=np.uint32)


def _tk(keys):
    return torch.as_tensor(keys.astype(np.int64))


@pytest.mark.parametrize("case", range(len(KEYS)))
def test_fold_in_bits_and_uniform_match_jax(case):
    keys = KEYS[case]
    pos = np.random.default_rng(case).integers(0, 2 ** 31 - 1, len(keys))
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                        jnp.asarray(pos, jnp.uint32))
    np.testing.assert_array_equal(
        prng.fold_in(_tk(keys), torch.as_tensor(pos)).numpy(),
        np.asarray(want).astype(np.int64))
    n = 131                     # odd, so no pairing of counters hides
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jnp.asarray(keys))
    np.testing.assert_array_equal(prng.random_bits(_tk(keys), n).numpy(),
                                  np.asarray(bits).astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    uni = jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=tiny))(
        jnp.asarray(keys))
    np.testing.assert_array_equal(prng.uniform(_tk(keys), n).numpy(),
                                  np.asarray(uni))
    gum = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jnp.asarray(keys))
    np.testing.assert_allclose(prng.gumbel(_tk(keys), n).numpy(),
                               np.asarray(gum), rtol=1e-6, atol=1e-6)


def test_threefry_known_answer():
    """Threefry-2x32, 20 rounds, against Random123's known-answer vector
    (key and counter all ones), the test JAX's own suite uses."""
    ones = torch.tensor(0xFFFFFFFF)
    y0, y1 = prng.threefry2x32(ones, ones, ones, ones)
    assert (int(y0), int(y1)) == (0x1CB996FC, 0xBB002BE7)


@pytest.mark.parametrize("case", range(len(KEYS)))
def test_categorical_matches_jax(case):
    """Tokens exact over 6 keys x 40 draws of 97 logits, some rows cut to
    -inf as top-k leaves them."""
    rng = np.random.default_rng(10 + case)
    keys = KEYS[case]
    got, want = [], []
    for draw in range(40):
        lg = (rng.standard_normal((len(keys), 97)) * 3).astype(np.float32)
        lg[draw % len(keys), rng.integers(0, 97, 60)] = -np.inf
        sub = rng.integers(0, 2 ** 32, keys.shape, dtype=np.uint32)
        want.append(np.asarray(jax.vmap(jax.random.categorical)(
            jnp.asarray(sub), jnp.asarray(lg))))
        got.append(prng.categorical(_tk(sub), torch.as_tensor(lg)).numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_req_key_matches_jax_engine(seed):
    stub = types.SimpleNamespace(_seed=seed)
    for rid in (0, 1, 5, 1000):
        np.testing.assert_array_equal(
            prng.req_key(seed, rid),
            jax_engine.ServingEngine._req_key(stub, rid))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (0.7, 5),
                                               (1.0, 0), (1.3, 50)])
def test_sample_matches_jax_sample(temperature, top_k):
    """The port's ``_sample`` against the JAX engine's, jitted with the
    temperature a constant as ``engine_step`` runs it: 8 rows x 20 draws
    of 128 logits, exact tokens."""
    rng = np.random.default_rng(21)
    b, v = 8, 128
    keys = rng.integers(0, 2 ** 32, (b, 2), dtype=np.uint32)
    jslots = jax_engine.init_slots(b, 4)._replace(rng=jnp.asarray(keys))
    slots = engine.init_slots(b, 4, torch.device("cpu"))._replace(
        rng=_tk(keys))
    jsample = jax.jit(lambda lg, w: jax_engine._sample(
        lg, jslots, w, temperature=temperature, top_k=top_k))
    for _ in range(20):
        lg = (rng.standard_normal((b, v)) * 4).astype(np.float32)
        wpos = rng.integers(0, 4096, b).astype(np.int32)
        want = np.asarray(jsample(jnp.asarray(lg), jnp.asarray(wpos)))
        got = engine._sample(torch.as_tensor(lg), slots,
                             torch.as_tensor(wpos).long(), temperature,
                             top_k)
        np.testing.assert_array_equal(got.numpy(), want)


MAX_LEN = 24


def _requests(vocab):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, int(rng.integers(2, 11))).tolist(),
             int(rng.integers(3, 9))) for _ in range(6)]


class _Recorder:
    """Keeps what the port's ``_sample`` saw (logits, keys, positions) to
    explain a token that differs from JAX's."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = engine._sample

        def traced(logits, slots, wpos, temperature, top_k):
            self.calls.append((logits.clone(), slots.rng.clone(),
                               wpos.clone(), temperature, top_k))
            return inner(logits, slots, wpos, temperature, top_k)

        monkeypatch.setattr(engine, "_sample", traced)

    def gap(self, key, wpos):
        """The two best perturbed scores' gap at (row key, position)."""
        for logits, rng, w, temperature, top_k in self.calls:
            rows = ((rng == _tk(key)).all(-1) & (w == wpos)).nonzero()
            if len(rows):
                r = int(rows[0])
                lg = logits[r:r + 1].float() * float(
                    np.float32(1) / np.float32(temperature))
                if top_k:
                    kth = torch.topk(lg, top_k).values[:, -1:]
                    lg = torch.where(lg < kth, -torch.inf, lg)
                sub = prng.fold_in(rng[r:r + 1], w[r:r + 1])
                score = prng.gumbel(sub, lg.shape[-1]) + lg
                top2 = torch.topk(score[0], 2).values
                return float(top2[0] - top2[1])
        return None


def _serve(cls, cache_cls, cfg_cls, model, params, reqs, layout, **kw):
    eng = cls(model, params, batch=4, max_len=MAX_LEN,
              cache=cache_cls(layout=layout, page_size=4),
              config=cfg_cls(**{"steps_per_sync": 3, **kw}))
    rids = [eng.submit(t, g) for t, g in reqs]
    outs = eng.run()
    return [np.asarray(outs[r]) for r in rids]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("temperature,top_k,seed", [(0.7, 0, 0), (0.7, 5, 1),
                                                    (1.0, 0, 1),
                                                    (1.0, 5, 0)])
@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke", "mamba2-2.7b-smoke"])
def test_sampled_streams_match_jax_engine(arch, temperature, top_k, seed,
                                          layout, monkeypatch):
    """Prompts of 2-10 tokens, 3-8 sampled, chunks of 4: the port's token
    streams equal the JAX engine's, token for token."""
    jcfg, tree, jparams = jax_params(arch=arch)
    reqs = _requests(jcfg.vocab_size)
    kw = dict(temperature=temperature, top_k=top_k, seed=seed,
              prefill_chunk=4)
    want = _serve(JaxServingEngine, JaxCacheConfig, JaxEngineConfig,
                  jax_build_model(jcfg), jparams, reqs, layout, **kw)
    rec = _Recorder(monkeypatch)
    got = _serve(ServingEngine, CacheConfig, EngineConfig,
                 build_model(get_arch(arch), device="cpu"),
                 params_from_jax(tree, device="cpu"), reqs, layout, **kw)
    for rid, ((prompt, _), g, w) in enumerate(zip(reqs, got, want)):
        if not np.array_equal(g, w):
            j = int(np.argmax(g != w))
            wpos = len(prompt) + j
            gap = rec.gap(prng.req_key(seed, rid), wpos)
            pytest.fail(f"request {rid}: token {j} (position {wpos}) "
                        f"{g[j]} != JAX's {w[j]}; the two best perturbed "
                        f"scores there differ by {gap}")


@pytest.fixture(scope="module")
def port_model():
    _, tree, _ = jax_params()
    return (build_model(get_arch("qwen2.5-3b-smoke"), device="cpu"),
            params_from_jax(tree, device="cpu"))


def _port_streams(port_model, layout="paged", **kw):
    model, params = port_model
    reqs = _requests(model.cfg.vocab_size)
    return _serve(ServingEngine, CacheConfig, EngineConfig, model, params,
                  reqs, layout, **kw)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sampled_streams_ignore_the_schedule(port_model, layout):
    """A token's key is (row key, position): the same streams under
    ``steps_per_sync`` {1, 4} x chunk {1, 4}."""
    runs = [_port_streams(port_model, layout, temperature=0.9, top_k=8,
                          seed=1, steps_per_sync=sps, prefill_chunk=c)
            for sps in (1, 4) for c in (1, 4)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    greedy = _port_streams(port_model, layout, prefill_chunk=4)
    assert any(not np.array_equal(a, b) for a, b in zip(runs[0], greedy))


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_top_k_one_is_greedy(port_model, temperature):
    greedy = _port_streams(port_model, prefill_chunk=4)
    got = _port_streams(port_model, prefill_chunk=4, temperature=temperature,
                        top_k=1, seed=3)
    for a, b in zip(got, greedy):
        np.testing.assert_array_equal(a, b)


def test_seed_changes_the_streams(port_model):
    a = _port_streams(port_model, temperature=1.0, seed=0)
    b = _port_streams(port_model, temperature=1.0, seed=1)
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("flags", [
    [],
    ["--temperature", "0.8", "--top-k", "50", "--seed", "3"],
    ["--layout", "paged", "--page-size", "8", "--prefix-sharing",
     "--prefill-chunk", "4", "--steps-per-sync", "2"],
    ["--layout", "paged", "--kv-dtype", "int8", "--temperature", "1.0"],
])
def test_configs_from_flags_match_jax(flags):
    """The same flags give the same fields as JAX's ``configs_from_flags``
    (``host_spill`` stays None on both sides, so a pool below the worst
    case gets the host tier and preempts into it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="contiguous")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", default="f32")
    ap.add_argument("--prefill-chunk", type=int, default=1)
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-sharing", action="store_true")
    args = ap.parse_args(flags)
    cache, config = configs_from_flags(args)
    jcache, jconfig = jax_config.configs_from_flags(args)
    for got, want in ((cache, jcache), (config, jconfig)):
        for f in ("layout", "page_size", "n_pages", "snapshots", "kv_dtype",
                  "steps_per_sync", "prefill_chunk", "prefix_sharing",
                  "prefill_budget", "seed", "temperature", "top_k"):
            if hasattr(want, f):
                assert getattr(got, f) == getattr(want, f), f
    assert cache.host_spill is None


@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke", "mamba2-2.7b-smoke"])
def test_serve_cli_samples_and_shares(arch, capsys):
    """``launch/serve.py`` takes the three flags: sampled streams, and the
    sharing counts (random prompts share nothing) and, for the recurrent
    family, the snapshot store's."""
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--requests", "3", "--prompt-len", "8", "--gen", "4",
                       "--layout", "paged", "--page-size", "4",
                       "--prefill-chunk", "4", "--temperature", "0.8",
                       "--top-k", "5", "--prefix-sharing"]) == 0
    out = capsys.readouterr().out
    assert "prefix sharing: 0 prompt tokens" in out
    assert ("state snapshots: peak" in out) == arch.startswith("mamba2")


def test_sampling_config_validation_matches_jax():
    with pytest.raises(ValueError, match="top_k must be >= 0"):
        EngineConfig(top_k=-1)
    assert EngineConfig().seed == JaxEngineConfig().seed == 0
    sampled = EngineConfig(temperature=0.7, top_k=5, seed=9)
    assert (sampled.temperature, sampled.top_k, sampled.seed) == (0.7, 5, 9)

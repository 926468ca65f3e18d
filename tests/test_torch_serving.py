"""The port's multi-tenant ServingEngine against the JAX package's, on the
reference's own serving setup (``tests/test_serving.py``: gemma-2b reduced
to 2 layers of d 256, two tenants whose adapters have non-zero B), from
bridged weights, and on rwkv6-3b the same way.

Greedy decoding must give the reference's tokens, request for request, and
the same ``stats``.  Temperature sampling draws from a torch Generator
(JAX's PRNG cannot be replayed), so it is held to determinism under a seed.
"""
import os

# the JAX reference runs on the CPU in these comparisons, also where its
# JAX could see an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.numerics import set_fp32_policy  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

set_fp32_policy()

TENANTS = ("client-a", "client-b")


@pytest.fixture(scope="module", params=["gemma-2b", "rwkv6-3b"])
def setup(request):
    arch = request.param
    jc = j_reduced(J_REGISTRY[arch], n_layers=2, d_model=256)
    tc = reduced(REGISTRY[arch], n_layers=2, d_model=256)
    jm = j_build(jc)
    params = jm.init_params(jax.random.PRNGKey(0))
    adapters = {}
    for i, tenant in enumerate(TENANTS):
        lo = jm.init_lora(jax.random.PRNGKey(10 + i))
        adapters[tenant] = jax.tree.map(
            lambda x, _i=i: jax.random.normal(jax.random.PRNGKey(20 + _i), x.shape) * 0.05,
            lo)
    np_params = jax.tree.map(np.asarray, params)
    np_adapters = {t: jax.tree.map(np.asarray, a) for t, a in adapters.items()}
    return (jc, params, adapters, tc, to_torch(np_params, "cpu"),
            {t: to_torch(a, "cpu") for t, a in np_adapters.items()})


def _requests(cls, vocab, n=5, prompt_len=6, max_new=8, seed=0, eos_id=None):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tenant=TENANTS[i % 2],
                prompt=rng.integers(2, vocab, size=prompt_len + i % 3).astype(np.int32),
                max_new_tokens=max_new, eos_id=eos_id) for i in range(n)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    return {r.uid: r.output for r in done}, [r.uid for r in done], dict(engine.stats)


@pytest.mark.parametrize("slots,cache_len", [(2, 64), (4, 32), (1, 16)])
def test_greedy_tokens_and_stats_match_reference(setup, slots, cache_len):
    jc, jp, ja, tc, tp, ta = setup
    j_out, j_order, j_stats = _serve(JServingEngine(jc, jp, ja, slots=slots,
                                                    cache_len=cache_len),
                                     _requests(JRequest, jc.vocab_size))
    with torch.no_grad():
        t_out, t_order, t_stats = _serve(ServingEngine(tc, tp, ta, slots=slots,
                                                       cache_len=cache_len, device="cpu"),
                                         _requests(Request, tc.vocab_size))
    assert t_order == j_order
    assert t_stats == j_stats
    assert t_stats["completed"] == 5 and t_stats["adapter_switches"] >= 2
    for uid, out in j_out.items():
        np.testing.assert_array_equal(t_out[uid], out)


def test_eos_and_recycling_match_reference(setup):
    """A token that the reference emits mid-request, made the EOS id, ends
    that request there on both sides; the slot is recycled."""
    jc, jp, ja, tc, tp, ta = setup
    j_out, _, _ = _serve(JServingEngine(jc, jp, ja, slots=1, cache_len=32),
                         _requests(JRequest, jc.vocab_size, n=3, max_new=4, seed=1))
    eos = int(j_out[0][1])
    j_out, j_order, j_stats = _serve(
        JServingEngine(jc, jp, ja, slots=1, cache_len=32),
        _requests(JRequest, jc.vocab_size, n=3, max_new=4, seed=1, eos_id=eos))
    with torch.no_grad():
        t_out, t_order, t_stats = _serve(
            ServingEngine(tc, tp, ta, slots=1, cache_len=32, device="cpu"),
            _requests(Request, tc.vocab_size, n=3, max_new=4, seed=1, eos_id=eos))
    assert len(j_out[0]) <= 2 and j_out[0][-1] == eos
    assert (t_order, t_stats) == (j_order, j_stats)
    for uid, out in j_out.items():
        np.testing.assert_array_equal(t_out[uid], out)


def test_engine_matches_single_request_decode(setup):
    """Batched, slotted serving gives the greedy tokens of a direct
    token-by-token decode with the same adapter (port alone)."""
    _, _, _, tc, tp, ta = setup
    prompt = np.asarray([3, 5, 7, 11], np.int32)
    n_new = 6
    eng = ServingEngine(tc, tp, ta, slots=2, cache_len=32, device="cpu")
    req = Request(uid=0, tenant="client-a", prompt=prompt, max_new_tokens=n_new)
    with torch.no_grad():
        _serve(eng, [req])
        model = build_model(tc, device="cpu")
        cache = model.init_cache(1, 32)
        logits = None
        for i, t in enumerate(prompt):
            logits, cache = model.serve_step(tp, ta["client-a"], cache,
                                             torch.tensor([[t]]), i)
        out = []
        for i in range(n_new):
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            logits, cache = model.serve_step(tp, ta["client-a"], cache,
                                             torch.tensor([[nxt]]), len(prompt) + i)
    np.testing.assert_array_equal(req.output, np.asarray(out, np.int32))


def test_tenant_isolation(setup):
    _, _, _, tc, tp, ta = setup
    prompt = np.asarray([3, 5, 7, 11, 13, 17], np.int32)
    outs = {}
    with torch.no_grad():
        for tenant in TENANTS:
            req = Request(uid=0, tenant=tenant, prompt=prompt, max_new_tokens=8)
            _serve(ServingEngine(tc, tp, ta, slots=1, cache_len=32, device="cpu"), [req])
            outs[tenant] = req.output
    assert not np.array_equal(outs["client-a"], outs["client-b"])


def test_temperature_sampling_is_seeded(setup):
    _, _, _, tc, tp, ta = setup

    def sample(seed):
        reqs = _requests(Request, tc.vocab_size, n=3, max_new=6, seed=2)
        for r in reqs:
            r.temperature = 1.0
        with torch.no_grad():
            out, _, _ = _serve(ServingEngine(tc, tp, ta, slots=2, cache_len=32, seed=seed,
                                             device="cpu"), reqs)
        return out

    first, again = sample(5), sample(5)
    assert sorted(first) == [0, 1, 2]
    for uid in first:
        np.testing.assert_array_equal(first[uid], again[uid])
        assert len(first[uid]) == 6 and (first[uid] < tc.vocab_size).all()


def test_unknown_tenant_raises(setup):
    _, _, _, tc, tp, ta = setup
    eng = ServingEngine(tc, tp, ta, device="cpu")
    with pytest.raises(KeyError):
        eng.submit(Request(uid=0, tenant="nobody", prompt=np.asarray([1], np.int32)))

"""The paper's memory model (Table I): the port's byte counts, built on the
``meta`` device, equal the reference's (``jax.eval_shape``) for bert-base,
gemma-2b and rwkv6-3b at their published widths, and the server and client
footprints built on them agree at every cut."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses

import pytest

pytest.importorskip("jax")

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.core import memory_model as j_mem  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.core import memory_model as t_mem  # noqa: E402

ARCHS = ("bert-base", "gemma-2b", "rwkv6-3b")
SCHEMES = ("ours", "sfl", "sl")
BATCH, SEQ = 16, 128


@pytest.fixture(scope="module")
def model_bytes():
    """Each package's ModelBytes per architecture, computed once."""
    return {arch: (t_mem.model_bytes(REGISTRY[arch]), j_mem.model_bytes(J_REGISTRY[arch]))
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bytes_equal_reference(arch, model_bytes):
    got, want = model_bytes[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.params() == want.params() and got.lora() == want.lora()
    # nothing was allocated: the port counted bytes on the meta device
    assert got.embed > 0 and got.per_layer > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_server_and_client_memory_at_every_cut(arch, model_bytes, monkeypatch):
    """server_memory for each scheme with every cut alone and with the paper
    cuts, and client_memory at every cut, equal the reference's.  Both
    packages read the ModelBytes pinned equal above."""
    got_mb, want_mb = model_bytes[arch]
    monkeypatch.setattr(t_mem, "model_bytes", lambda cfg: got_mb)
    monkeypatch.setattr(j_mem, "model_bytes", lambda cfg: want_mb)
    tc, jc = REGISTRY[arch], J_REGISTRY[arch]
    cut_sets = [[c] for c in range(1, tc.n_layers)] + [[1, 1, 2, 2, 3, 3]]
    for scheme in SCHEMES:
        for cuts in cut_sets:
            got = t_mem.server_memory(tc, scheme, cuts, BATCH, SEQ)
            want = j_mem.server_memory(jc, scheme, cuts, BATCH, SEQ)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (scheme, cuts)
    for cut in range(0, tc.n_layers + 1):
        assert (t_mem.client_memory(tc, cut, BATCH, SEQ, mb=got_mb)
                == j_mem.client_memory(jc, cut, BATCH, SEQ, mb=want_mb)), cut
        assert (t_mem.activation_bytes_training(tc, cut, BATCH, SEQ)
                == j_mem.activation_bytes_training(jc, cut, BATCH, SEQ))


def test_paper_claim_ours_below_sfl(model_bytes, monkeypatch):
    """The paper's headline: one resident server model for all clients
    needs far less server memory than one submodel per client (sfl)."""
    monkeypatch.setattr(t_mem, "model_bytes", lambda cfg: model_bytes["bert-base"][0])
    cfg = REGISTRY["bert-base"]
    cuts = [1, 1, 2, 2, 3, 3]
    ours = t_mem.server_memory(cfg, "ours", cuts, BATCH, SEQ).total
    sfl = t_mem.server_memory(cfg, "sfl", cuts, BATCH, SEQ).total
    assert ours < 0.3 * sfl


def test_tree_bytes_counts_each_dtype():
    import torch
    tree = {"a": torch.zeros(3, 4, device="meta"),
            "b": {"c": torch.zeros(5, dtype=torch.bfloat16, device="meta")}}
    assert t_mem.tree_bytes(tree) == 3 * 4 * 4 + 5 * 2

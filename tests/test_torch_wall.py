"""The port's spans (``repro_torch.obs.wall``) on a small decoder's LM
server step on the CPU: a step gives the same bits with spans on and off;
off, a span is the shared no-op and adds nothing (no hook, view, event or
allocator read); on, it adds one view and two hooks a region, each
``.bwd`` bracket holds its own layer's backward nodes and no other's, the
brackets never nest, a forward recomputed in the backward records no
span, and the device self seconds add up."""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import REGISTRY, reduced
from repro_torch.core import splitfl
from repro_torch.models import build_model
from repro_torch.obs import wall
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map

# tiny shapes: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

N_LAYERS, CUT = 4, 1
SERVER = N_LAYERS - CUT
# a span a layer each, two norms a layer, the head once
COUNTS = {"server_step": 1, "forward": 1, "backward": 1, "optimizer": 1, "lm_head": 1,
          "attention": SERVER, "mlp": SERVER, "norm": 2 * SERVER}
BWD = {"attention": SERVER, "mlp": SERVER, "norm": 2 * SERVER, "lm_head": 1}
# a node of each region's backward: the softmax, the SiLU gate, the norm's
# rsqrt (the final norm's lies in the head)
NODE_OF = {"SoftmaxBackward0": ("attention.bwd",), "SiluBackward0": ("mlp.bwd",),
           "RsqrtBackward0": ("norm.bwd", "lm_head.bwd")}


@pytest.fixture(autouse=True)
def fresh_recorder():
    wall.reset()
    yield
    wall.reset()


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(REGISTRY["granite-3-2b"], n_layers=N_LAYERS, d_model=64)
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params, lora = model.init_params(gen), model.init_lora(gen)
    # a nonzero B, so that every adapter has a gradient
    lora = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=gen), lora)
    opt = AdamW(1e-3)
    v = torch.randn(2, 8, cfg.d_model, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    batch = {"tokens": ids[:, :8], "targets": ids[:, 1:]}
    step = splitfl.make_server_step(model, opt, static_cut=CUT)
    return model, step, params, lora, opt.init(lora), v, batch


def _step(setup):
    _, step, params, lora, state, v, batch = setup
    return step(params, lora, state, v, batch)


def _profiled(setup):
    with profile(activities=[ProfilerActivity.CPU]):
        return _step(setup)


def _loss(setup, **kw):
    model, _, params, lora, _, v, batch = setup
    lo = splitfl.as_trainable(lora)
    with torch.enable_grad():
        loss, _ = model.loss(params, lo, batch, cut=CUT, side="server",
                             x0=v.detach().requires_grad_(True), **kw)
    return loss


def _nodes(loss) -> list:
    """Every autograd node the loss's backward can reach."""
    seen, todo = {}, [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        todo.extend(fn for fn, _ in node.next_functions)
    return list(seen.values())


def test_step_is_bit_equal_with_spans_on_and_off(setup):
    off = _step(setup)
    on = _profiled(setup)
    assert len(wall.recorded()) > 0
    a, b = tree_leaves(tuple(off)), tree_leaves(tuple(on))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_off_span_is_the_shared_no_op_and_adds_nothing(setup, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    a, b = wall.span("a"), wall.span("b")
    assert a is b
    t = torch.ones(2, requires_grad=True)
    with a as sp:
        assert sp.input(t) is t and sp.output(t) is t

    def refuse(*args, **kwargs):
        raise AssertionError("a span with the profiler off touched the recorder")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(wall, "_allocated", refuse)
    monkeypatch.setattr(wall, "Span", refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
    _step(setup)
    _loss(setup).backward()
    assert wall.recorded() == [] and wall.summary() == {}


def test_on_span_adds_a_view_and_two_hooks_a_region(setup, monkeypatch):
    off = Counter(n.name() for n in _nodes(_loss(setup)))
    hooked = []
    register = torch.Tensor.register_hook

    def count(t, fn):
        hooked.append(fn.__name__)
        return register(t, fn)

    monkeypatch.setattr(torch.Tensor, "register_hook", count)
    with profile(activities=[ProfilerActivity.CPU]):
        on = Counter(n.name() for n in _nodes(_loss(setup)))
    regions = sum(BWD.values())
    assert sorted(hooked) == sorted(["begin", "end"] * regions)
    on["ViewBackward0"] -= regions
    assert +on == +off


def _logged_backward(setup, monkeypatch) -> list:
    """One profiled server loss and its backward, with every span's open
    and close and every autograd node's start and end logged in order."""
    log = []
    init, close = wall.Span.__init__, wall.Span.close

    def logged_init(self, name, req, with_bytes):
        init(self, name, req, with_bytes)
        log.append(("open", name))

    def logged_close(self):
        if not self.dropped:
            log.append(("close", self.name))
        close(self)

    monkeypatch.setattr(wall.Span, "__init__", logged_init)
    monkeypatch.setattr(wall.Span, "close", logged_close)
    with profile(activities=[ProfilerActivity.CPU]):
        loss = _loss(setup)
        for node in _nodes(loss):
            name = node.name()
            node.register_prehook(lambda g, name=name: log.append(("start", name)))
            node.register_hook(lambda gi, go, name=name: log.append(("end", name)))
        log.clear()
        loss.backward()
    return log


def test_bwd_brackets_hold_their_layers_nodes_and_no_other(setup, monkeypatch):
    log = _logged_backward(setup, monkeypatch)
    open_, inside = [], Counter()
    for what, name in log:
        if what == "open":
            open_.append(name)
        elif what == "close":
            assert open_.pop() == name
        elif name in NODE_OF:
            assert len(open_) == 1 and open_[0] in NODE_OF[name], (what, name, open_)
            inside[name, open_[0]] += what == "start"
    assert open_ == []
    assert inside == {("SoftmaxBackward0", "attention.bwd"): SERVER,
                      ("SiluBackward0", "mlp.bwd"): SERVER,
                      ("RsqrtBackward0", "norm.bwd"): 2 * SERVER,
                      ("RsqrtBackward0", "lm_head.bwd"): 1}


def test_bwd_brackets_follow_one_another_and_never_nest(setup, monkeypatch):
    log = _logged_backward(setup, monkeypatch)
    spans = [(what, name) for what, name in log if what in ("open", "close")]
    assert Counter(name for what, name in spans if what == "open") == \
        {f"{n}.bwd": c for n, c in BWD.items()}
    # open, close, open, close ...: one bracket at a time
    assert [what for what, _ in spans] == ["open", "close"] * sum(BWD.values())
    # from the head down, each layer's MLP, its norm, its attention, its norm
    order = [name for what, name in spans if what == "open"]
    assert order == ["lm_head.bwd"] + ["mlp.bwd", "norm.bwd", "attention.bwd",
                                       "norm.bwd"] * SERVER


def test_a_forward_recomputed_in_the_backward_records_no_span(setup):
    with profile(activities=[ProfilerActivity.CPU]):
        with wall.span("step"):
            _loss(setup, path="scan", remat=True).backward()
    spans = wall.recorded()
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    # the server's layers run once forward; the checkpoints' recompute
    # inside the backward records nothing
    assert names["attention"] == names["attention.bwd"] == SERVER
    assert names["mlp"] == names["mlp.bwd"] == SERVER
    for s in spans:
        if s.name.endswith(".bwd"):
            continue
        p = s.parent
        while p is not None:
            assert not by_id[p].name.endswith(".bwd")
            p = by_id[p].parent


def test_each_step_is_a_request_of_one_tree(setup):
    for _ in range(2):
        _profiled(setup)
    spans = wall.recorded()
    reqs = {}
    for s in spans:
        reqs.setdefault(s.req, []).append(s)
    assert len(reqs) == 2
    for ss in reqs.values():
        roots = [s for s in ss if s.parent is None]
        assert [s.name for s in roots] == ["server_step"]
        ids = {s.id: s for s in ss}
        assert all(s.parent in ids for s in ss if s is not roots[0])
        for s in ss:
            if s.name.endswith(".bwd"):
                assert ids[s.parent].name == "backward"
        assert Counter(s.name for s in ss) == {**COUNTS,
                                               **{f"{n}.bwd": c for n, c in BWD.items()}}
    summ = wall.summary()
    assert all(r["device_s"] is None and r["bytes_held"] is None for r in summ.values())


def test_device_self_seconds_add_up(setup):
    _profiled(setup)
    spans = wall.recorded()
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)

    def fill(s):                     # a span's seconds: one of its own and its children's
        s.device_s = 1.0 + sum(fill(c) for c in children.get(s.id, []))
        return s.device_s

    for root in children[None]:
        fill(root)
    summ = wall.summary()
    for name, row in summ.items():
        assert row["device_self_s"] == pytest.approx(row["count"])
    assert sum(r["device_self_s"] for r in summ.values()) == \
        pytest.approx(summ["server_step"]["device_s"])
    assert summ["forward"]["device_self_s"] == pytest.approx(
        summ["forward"]["device_s"]
        - sum(summ[n]["device_s"] for n in ("attention", "mlp", "norm", "lm_head")))


def test_a_backward_that_stops_above_a_region_leaves_no_span_open(setup):
    model, _, params, lora, _, v, batch = setup
    lo = splitfl.as_trainable(lora)
    attn = dict(lo["layers"]["attn"])
    with profile(activities=[ProfilerActivity.CPU]):
        with wall.span("outer"):
            with torch.enable_grad():
                loss, _ = model.loss(params, lo, batch, cut=CUT, side="server",
                                     x0=v.detach().requires_grad_(True))
                # only the adapters: no gradient reaches the first server layer's input
                torch.autograd.grad(loss, tree_leaves(attn))
    assert wall._state.stack == []
    names = Counter(s.name for s in wall.recorded())
    assert names["outer"] == 1
    # the first server layer's attention input marker never runs: its bracket is
    # dropped, and its first norm's backward never begins
    assert names["attention.bwd"] == SERVER - 1
    assert names["norm.bwd"] == 2 * SERVER - 1
    assert names["mlp.bwd"] == SERVER

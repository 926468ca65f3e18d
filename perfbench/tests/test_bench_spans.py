"""The readers of the program's own spans (``attention_share``,
``attention_tape_share``) on a recorder filled by hand: each computes its
formula over the slice traced with the device's activity alone, and reads
nothing where no spans, no device intervals or no allocator readings were
recorded, or where the program has no recorder."""
import sys
import types

import pytest

from harness import cells

GB = 10**9
STEPS = 2          # server steps in each traced slice


@pytest.fixture
def wall():
    from repro_torch.obs import wall
    wall.reset()
    yield wall
    wall.reset()


def _fill(wall, device=True, nbytes=True, steps=STEPS):
    """``steps`` server steps of one attention layer each: the step 10 s of
    device time, attention 2 s forward and 3 s backward, the MLP 1 s; the
    attention leaves 4 GB allocated, and 40 GB are live at the backward."""
    st = wall._state

    def add(name, req, parent, dev, held=None, entry=None):
        s = object.__new__(wall.Span)
        s.name, s.req, s.id, s.parent = name, req, st.next_id, parent
        st.next_id += 1
        s.events, s.dropped = None, False
        s.device_s = dev if device else None
        s.bytes_in = s.bytes_out = None
        if nbytes and held is not None:
            s.bytes_in, s.bytes_out = entry, entry + held
        st.ring.append(s)
        return s.id

    for _ in range(steps):
        req, st.next_req = st.next_req, st.next_req + 1
        step = add("server_step", req, None, 10.0, 0, 30 * GB)
        fwd = add("forward", req, step, 3.0, 6 * GB, 30 * GB)
        add("attention", req, fwd, 2.0, 4 * GB, 31 * GB)
        add("mlp", req, fwd, 1.0, 2 * GB, 35 * GB)
        bwd = add("backward", req, step, 6.0, -5 * GB, 40 * GB)
        add("attention.bwd", req, bwd, 3.0)
        add("mlp.bwd", req, bwd, 1.5)
        add("optimizer", req, step, 1.0, 0, 35 * GB)


def _read(name, steps=STEPS):
    ctx = types.SimpleNamespace(work={"attempted": steps})
    return cells.metric_reader(name).read(ctx)


def test_attention_share_is_attention_and_its_backward_over_the_step(wall):
    _fill(wall)
    assert _read("attention_share") == pytest.approx(100.0 * (2 + 3) / 10)
    summ = wall.summary()
    assert summ["forward"]["device_self_s"] == pytest.approx(STEPS * (3.0 - 2.0 - 1.0))
    assert summ["backward"]["device_self_s"] == pytest.approx(STEPS * (6.0 - 3.0 - 1.5))


def test_attention_tape_share_is_bytes_held_over_the_live_set_at_the_backward(wall):
    _fill(wall, steps=3)
    assert _read("attention_tape_share", steps=3) == pytest.approx(100.0 * 3 * 4 / (3 * 40))


def test_the_slice_traced_with_host_ops_is_left_out(wall):
    # the first slice as above; the second's attention takes every second of
    # the step's and holds everything live (the shares at 100 %), and counts
    # no further
    _fill(wall)
    st = wall._state
    first = len(st.ring)
    _fill(wall)
    for s in list(st.ring)[first:]:
        if s.name.startswith("attention"):
            s.device_s = 10.0 if s.name == "attention" else 0.0
            if s.bytes_in is not None:
                s.bytes_in, s.bytes_out = 0, 40 * GB
    assert _read("attention_share") == pytest.approx(50.0)
    assert _read("attention_tape_share") == pytest.approx(10.0)
    assert _read("attention_share", steps=2 * STEPS) == pytest.approx(75.0)


@pytest.mark.parametrize("metric", ["attention_share", "attention_tape_share"])
def test_nothing_recorded_reads_nothing(wall, metric):
    assert _read(metric) is None


def test_no_device_interval_reads_no_share(wall):
    _fill(wall, device=False)
    assert _read("attention_share") is None
    assert _read("attention_tape_share") == pytest.approx(10.0)


def test_no_allocator_reading_reads_no_tape_share(wall):
    _fill(wall, nbytes=False)
    assert _read("attention_tape_share") is None
    assert _read("attention_share") == pytest.approx(50.0)


@pytest.mark.parametrize("metric", ["attention_share", "attention_tape_share"])
def test_a_program_without_a_recorder_reads_nothing(wall, metric, monkeypatch):
    _fill(wall)
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "wall")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.wall", None)
    assert _read(metric) is None

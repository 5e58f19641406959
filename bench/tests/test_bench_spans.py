"""The readers of the program's spans (``bench/spans.py``,
``bench/metrics/{local_ms,restage_ms,captures_per_call,exchange_ms}``) on
hand-made span records, and none of them reading anything on the CPU."""

import pytest
import torch

from bench import harness, spans, trace
from repro_torch.spans import Span

NEW = ("local_ms", "restage_ms", "captures_per_call", "exchange_ms", "local_ms.4card",
       "restage_ms.4card")


def _span(name, ms, **attrs):
    return Span(name, 0, None, 0, int(ms * 1e6), attrs)


def _ctx(runs, device="cuda"):
    ctx = harness.Context(cell=None, inputs=None, trainer=None,
                          devices=[torch.device(device)], window={}, trace=None, wire={},
                          peaks=None)
    if runs is not None:
        ctx._memo[spans.MEMO] = runs
    return ctx


def _calls():
    """Two calls on two shards: shard 1's local steps are the slower."""
    def call(stage, local0, local1, exchange, captures):
        return spans.Call([
            _span("fused.call", 999.0),
            _span("fused.program", stage), _span("fused.stage", 2 * stage),
            _span("fused.chunk", 50.0), _span("trainer.eval", 70.0), _span("eval.test_set", 7.0),
            _span("piece.eager", 10.0, piece="local", shard=0),
            _span("piece.eager", 10.0, piece="local", shard=1),
            *[_span("piece.capture", 60.0 / captures, piece="local", shard=k % 2)
              for k in range(captures)],
            *[_span("piece.replay", 0.1, piece="local", shard=0, device_ms=v) for v in local0],
            *[_span("piece.replay", 0.1, piece="local", shard=1, device_ms=v) for v in local1],
            _span("piece.replay", 0.1, piece="rows", shard=0, device_ms=500.0),
            *[_span("sharded.exchange", v, slot=0) for v in exchange],
            _span("fused.gather", 4.0), _span("fused.close", 1.0),
        ])
    return [call(1.0, [1.0, 2.0, 3.0], [5.0, 6.0, 7.0], [0.5, 0.7], 6),
            call(3.0, [1.5], [4.0], [0.9], 4)]


def test_readers_on_hand_made_spans():
    ctx = _ctx(_calls())
    read = {m: harness._reader(m) for m in NEW}
    # Per call: program + stage + eager + capture + gather + close, the
    # median of the two calls; the chunk, rounds and evaluations left out.
    first = 1.0 + 2.0 + 20.0 + 60.0 + 4.0 + 1.0
    second = 3.0 + 6.0 + 20.0 + 60.0 + 4.0 + 1.0
    assert read["restage_ms"](ctx) == pytest.approx((first + second) / 2)
    # The slowest shard's median replay of the local steps, over both calls.
    assert read["local_ms"](ctx) == pytest.approx(5.5)
    assert read["captures_per_call"](ctx) == pytest.approx(5.0)
    assert read["exchange_ms"](ctx) == pytest.approx(0.7)
    assert read["local_ms.4card"](ctx) == read["local_ms"](ctx)
    assert read["restage_ms.4card"](ctx) == read["restage_ms"](ctx)
    assert spans.calls(ctx)[0].restage_ms() == pytest.approx(first)
    assert "restage 88.000 ms; captures 6" in spans.calls(ctx)[0].line()


def test_readers_without_the_pieces_they_read():
    ctx = _ctx([spans.Call([_span("fused.call", 9.0)])])
    assert harness._reader("local_ms")(ctx) is None
    assert harness._reader("exchange_ms")(ctx) is None
    assert harness._reader("restage_ms")(ctx) == 0.0
    assert harness._reader("captures_per_call")(ctx) == 0.0


@pytest.mark.parametrize("metric", NEW)
def test_no_reading_on_the_cpu(metric):
    ctx = _ctx(None, device="cpu")
    assert harness._reader(metric)(ctx) is None
    assert ctx._memo[spans.MEMO] is None


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._t = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def end_ns(self):
        return self._s + self._t

    def device_index(self):
        return 0

    def is_async(self):
        return False


def test_idle_goes_to_the_innermost_program_span():
    """A gap is named after the innermost program span around its midpoint,
    whatever aten or runtime call was running; outside every span, after
    the traced window."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Ev(trace.SPAN, cpu, 0, 1000),
        _Ev("fused.call", cpu, 0, 900),
        _Ev("fused.stage", cpu, 0, 300),
        _Ev("aten::index_select", cpu, 100, 150),
        _Ev("kernel", gpu, 300, 100),
        _Ev("fused.round", cpu, 400, 400),
        _Ev("piece.capture", cpu, 450, 250),
        _Ev("cudaStreamBeginCapture", cpu, 460, 1),
        _Ev("cudaStreamEndCapture", cpu, 690, 1),
        _Ev("kernel", gpu, 700, 200),
    ]
    names = {"fused.call", "fused.stage", "fused.round", "piece.capture"}
    idle = dict(spans.idle_by_span(events, names).idle_gaps)
    assert idle == {"fused.stage": pytest.approx(300e-9), "piece.capture": pytest.approx(300e-9),
                    trace.SPAN: pytest.approx(100e-9)}

"""The trace's reduction on made-up events: busy time, idle gaps named by
the host, and a span's device seconds counting its operations and not the
waits between them."""

from torch.autograd import DeviceType

from nowcast_bench import trace


class Ev:
    def __init__(self, name, s, e, cuda=False, span=False, thread=1):
        self._n, self._s, self._d = name, s, e - s
        self._cuda, self._span, self._t = cuda, span, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def is_user_annotation(self):
        return self._span

    def start_thread_id(self):
        return self._t


def _events():
    return [
        Ev("nb.window", 0, 1000),
        Ev("nb.encode", 10, 200), Ev("aten::conv", 20, 60),
        Ev("nb.decode", 300, 700),
        # on the device: two encode kernels with a wait for the host between
        Ev("k1", 100, 150, cuda=True), Ev("k2", 180, 220, cuda=True),
        Ev("nb.encode", 100, 220, cuda=True, span=True),
        Ev("k3", 400, 600, cuda=True),
        Ev("nb.decode", 400, 600, cuda=True, span=True),
        Ev("nb.window", 0, 1000, cuda=True, span=True),
    ]


def test_busy_idle_and_span_seconds():
    t = trace.reduce(_events())
    assert t.window_s == 1000 / 1e9 and t.busy_s == 290 / 1e9
    assert abs(t.span_seconds("nb.encode") - 90 / 1e9) < 1e-15
    assert abs(t.span_seconds("nb.decode") - 200 / 1e9) < 1e-15
    assert t.span_seconds("nb.call") == 0
    assert {n for n, _, _ in t.ops} == {"k1", "k2", "k3"}     # spans are no operations
    assert abs(t.idle_by_host["aten::conv"] - 100 / 1e9) < 1e-15    # 0-100, middle at 50
    assert abs(sum(t.idle_by_host.values()) - 710 / 1e9) < 1e-15

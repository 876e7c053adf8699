"""The device summary on hand-made profiler events."""

from types import SimpleNamespace

from permbench import devtrace


class Ev:
    def __init__(self, name, start, dur, dev="CPU", kind="cpu_op"):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._k = dev, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def activity_type(self):
        return self._k


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_idle_and_labels():
    K = "void (anonymous namespace)::ryser_walk_kernel<32, 0>(long*, int)"
    evs = [Ev(devtrace.WINDOW, 0, 1000),
           # call 1: [100, 600]: pack [150, 200], walk [200, 500]
           Ev(devtrace.CALL, 100, 500), Ev("span:permanent[df64]", 110, 480),
           Ev("span:pack", 150, 50), Ev("span:walk", 200, 300),
           Ev(K, 250, 200, "CUDA", "kernel"),
           # a marked range on the card's timeline is no device work
           Ev("span:walk", 200, 300, "CUDA", "gpu_user_annotation"),
           # call 2: [700, 900], a copy in it
           Ev(devtrace.CALL, 700, 200),
           Ev("Memcpy DtoH ", 800, 50, "CUDA", "gpu_memcpy")]
    t = devtrace.summarize(_prof(evs), True)
    assert abs(t.window_s - 1000e-9) < 1e-15
    assert abs(t.busy_s - 250e-9) < 1e-15
    assert abs(t.kernel_s("ryser_walk_kernel") - 200e-9) < 1e-15
    assert t.device_ops[0][0] == "ryser_walk_kernel<32, 0>"
    idle = dict(t.idle_gaps)
    # idle: [0,250) [450,800) [850,1000)
    # [0,100) between; [100,150) dispatch; [150,200) pack; [200,250) walk;
    # [450,500) walk; [500,600) dispatch; [600,700) between;
    # [700,800) dispatch; [850,900) dispatch; [900,1000) between
    want = {"between_calls": (100 + 100 + 100) * 1e-9,
            "dispatch": (50 + 100 + 100 + 50) * 1e-9,
            "pack": 50e-9, "walk": (50 + 50) * 1e-9}
    assert set(idle) == set(want)
    for k in want:
        assert abs(idle[k] - want[k]) < 1e-15, k
    assert abs(sum(idle.values()) + t.busy_s - t.window_s) < 1e-15


def test_short_names():
    assert devtrace.short_name(
        "void (anonymous namespace)::modp_walk_kernel<32>(long long const*)"
    ) == "modp_walk_kernel<32>"
    long = "at::native::elementwise_kernel<128, 2, " + "x" * 200 + ">(int)"
    assert devtrace.short_name(long) == "at::native::elementwise_kernel"
    assert devtrace.base_name("ryser_batch_kernel<24, 0>") == \
        "ryser_batch_kernel"

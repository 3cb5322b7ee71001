"""Share of the traced slice in which no operation (kernel, copy, set) ran
on the device, from the profiler's timeline."""


def read(win):
    dt = win.device_trace
    if dt is None or not dt.events or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)

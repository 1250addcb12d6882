"""The device's idle share in the traced window: one minus the union of GPU
activity (kernels, copies, sets) over the window. Read for every cell's
device_idle_pct.<part>, each named by the end-to-end metric it moves."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)

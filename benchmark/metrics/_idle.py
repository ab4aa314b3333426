"""Shared by the device_idle readers: the share of the traced window in
which no kernel, memcpy or memset ran on the device, %."""


def idle_percent(ctx) -> float | None:
    tr = ctx.trace
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

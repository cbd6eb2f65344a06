"""replay.device_idle_pct: the share of the traced window in which no device
operation ran, 100 less the union of the device operations' intervals (%)."""


def read(run):
    s = run.summary
    if not s or s["window_s"] <= 0 or not s["device_ops"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])

"""Share of the traced round in which the device was idle while the host
was inside an SSD layer's scan: the self time of the port's
``train.ssd_scan`` spans (models/ssm.py: B5, the chunks' hand-off loop,
the inter-chunk output), the idle time split over the port's innermost
spans by overlap (hippo_bench/port_spans.py).  Part of
``train.host_idle``'s time; None where the program records no such
span."""

from hippo_bench import port_spans


def read(run):
    lay = port_spans.layout(run)
    if lay is None:
        return None
    idle = lay.idle_by_name().get("train.ssd_scan")
    if idle is None:
        return None
    return 100.0 * idle / (lay.t1 - lay.t0)

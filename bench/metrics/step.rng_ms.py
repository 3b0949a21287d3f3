"""Device milliseconds a production step spends in the PRNG and the
aggregate: every device operation whose launch the host issued inside
the masks' draws, the channel's or the aggregate (``core/randk.py``
``mask_tree``, ``launch/steps.py`` ``_round_channel``,
``core/aggregation.py`` ``pfels_production_aggregate``), by the layer
that launched it and not by its kernel's name, so that a kernel that
takes over the threefry hash or the exact FMA under a name of its own
still counts."""

SPANS = ("masks", "channel", "aggregate")


def read(rec):
    if rec.span_units <= 0:
        return None
    s = rec.device_s_in_spans(SPANS)
    if s <= 0:
        return None
    return 1e3 * s / rec.span_units

"""feed_wait_ms: the feed layer (``repro_torch.feed.DeviceFeeder``): ms a
step the train loop blocked in ``next()`` waiting for a batch on the card,
``FeedMetrics.idle_s`` over the window's steps (host clock, the program's
counter)."""


def read(run):
    win = run["window"]
    if not win["feed_steps"]:
        return None
    return win["feed_idle_s"] / win["feed_steps"] * 1e3

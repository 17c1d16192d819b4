"""The share of the lanes given a free flight whose flight stopped in
the medium, over the profiled frames, in %: the port's counter
media.events (each bounce's lanes scattered in the medium) over
media.lanes (each bounce's active lanes handed to medium_sample)."""
from pbench import media_layers


def read(r):
    lay = media_layers.of(r)
    if lay is None:
        return None
    return 100.0 * lay.counters.get("media.events", 0) / lay.counters["media.lanes"]

"""search.host_ms (also search.host_ms.small, which moves request_p95_ms):
a search call's host part, in ms: the benchmark's span around each call
of the index's search, less its span around the outermost search_device
inside it (synchronised on both ends in the traced run), summed over the
window over the calls.  It counts staging, the query upload, the answers'
download and the graph's host re-score."""

from portbench.readers import host_ms as read  # noqa: F401

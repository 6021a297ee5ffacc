"""device_idle (device_idle.batch, .small, .ingest: one a cell kind, each
moving its cells' end-to-end metric): the share of the traced window in
which no kernel, copy or memset ran on the card (torch.profiler's device
events, their union against the window)."""

from portbench.readers import idle_percent as read  # noqa: F401

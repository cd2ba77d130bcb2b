"""`issue_idle_pct` in the cells whose step the host's dispatch paces, read as
there; a per-layer metric of its own, since it moves those cells'
`info_Mbps.host_paced`."""
from gpubench import registry

read = registry.metric_reader("issue_idle_pct").read

"""`info_Mbps` in the cells whose step the host's dispatch paces, read as
there; an end-to-end metric of its own so that those cells' wider spread sets
its own bound and leaves `info_Mbps`'s to the other cells."""
from gpubench import registry

read = registry.metric_reader("info_Mbps").read

"""`batch_ms_p95` in the cells whose step the host's dispatch paces, read as
there; an end-to-end metric of its own so that those cells' wider spread sets
its own bound and leaves `batch_ms_p95`'s to the other cells."""
from gpubench import registry

read = registry.metric_reader("batch_ms_p95").read

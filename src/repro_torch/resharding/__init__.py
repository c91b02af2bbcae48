"""Cross-layout resharding. Only the row-grid alignment arithmetic
(``rowgrid``), which the client's chunker uses, is ported so far; the
layout, planner and executor come with the repack kernels."""

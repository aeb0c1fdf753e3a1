"""The port's benchmark: ``python -m video3d_tpu_torch.bench`` (the
reference ``bench.py``'s JSON line), the V=32 flagship modes
(:mod:`.flagship`), dense vs paged decode (:mod:`.paged_batcher`), the HBM
stream probes of kernel B9 (:mod:`.probes`) and the timing rules they share
(:mod:`.timing`)."""

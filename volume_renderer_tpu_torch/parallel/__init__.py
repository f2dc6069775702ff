"""Paths that spread one render over several devices: z-bricks
(``bricks``), bands of image rows (``sharding``, ``pallas_dp``), and both at
once (a rows x bricks mesh in ``bricks``), driven from one process over a
device list (``mesh`` makes the lists); and, across processes over
``torch.distributed`` (``multihost``), bands of image rows or z-bricks, a
band or a brick a rank, or both: brick b over band r on rank (r, b) of a
rows x bricks mesh of ranks."""

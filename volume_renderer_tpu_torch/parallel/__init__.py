"""Paths that spread one render over several devices: z-bricks
(``bricks``), bands of image rows (``sharding``, ``pallas_dp``), and both at
once (a rows x bricks mesh in ``bricks``), driven from one process over a
device list (``mesh`` makes the lists); and bands of image rows across
processes over ``torch.distributed`` (``multihost``)."""

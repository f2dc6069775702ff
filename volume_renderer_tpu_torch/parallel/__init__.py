"""Paths that spread one render over several devices: z-bricks
(``bricks``), bands of image rows (``sharding``, ``pallas_dp``), and both at
once (a rows x bricks mesh in ``bricks``); ``mesh`` makes the device lists."""

"""The general traffic generators, one module a loop. A traffic mix is a
data file ``traffic/<mix>.json`` whose ``loop`` key names a module here
(found by ``named.module("loops", loop)``); every other key is a parameter
of that loop. A loop module has these functions, each taking the cell's
``cell.Context``:

- ``setup(ctx)``: builds the program's state and warms up every shape the
  window uses;
- ``window(ctx, seconds) -> cell.Window``: the timed loop;
- ``route(ctx, window) -> [str]``: what is wrong with the route the
  window took (the program's own counters), empty if nothing;
- ``release(ctx)``: frees the program's state once the peak is read;
- ``check(ctx, window) -> {number: value}``: what the timed path produced
  against the plain reference;
- ``least(ctx, window) -> {"fwd"|"bwd": {"seconds", "bound"}, "flops"}``:
  the kernels' least times and the window's operations, by the
  benchmark's own count (traced runs only);
- ``readings(ctx, faults, frames) -> dict``: the numbers that set the
  check's limits, read on the card by ``vr_bench.control``.
"""

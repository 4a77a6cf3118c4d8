"""One module per kind of traffic (a traffic file's ``kind``): its
``run(cell, seed, seconds, trace, device, started)`` makes one run of a cell
and returns the result line."""

"""The op kinds a traffic mix can name (its ``"op"`` key), one module
each: ``Op(cell, seed, device, spans, fault)`` makes the key, the
engines and the requests from the seed and runs one warm request;
``call`` is the timed call; ``keep`` takes, after a request's latency,
what the reference judges; ``work`` lists the ladders a request needs
(``benchmark.roofline``); ``check`` runs the reference once the window
has closed.  A mix's numbers (batch, pool, sample sizes) are data in
``benchmark/traffic/<mix>.json``.
"""

"""Long operational runs of the port, each a module run with ``python -m``:

* ``runs.sustained``: the sustained stream of 1.029e10 k-mers from
  device-resident batches, with a real kill and a bit-exact resume;
* ``runs.ingest``: a multi-GB FASTQ counted under a host memory budget,
  and the checkpointed ``count`` killed and resumed.

Each checks its own result and can write a JSON record of what it
measured (``--record``).
"""

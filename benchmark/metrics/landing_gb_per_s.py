"""Trim to host, the landing (``ops.landing.trim_rows``' ``trim.copy``:
the live columns copied from the card into host memory, through the
pinned ring): GB a second of the copies' device time.

The bytes of the device-to-host copies launched inside the trace's
``trim.copy`` ranges, from each copy event's own ``bytes`` argument, over
their summed device time.  GB is 1e9 bytes.  None without such a copy
(a table already on the host lands with no device copy).
"""


def read(run):
    copies = [d for d in run.trace.launched_in(("trim.copy",))
              if d.cat == "gpu_memcpy" and "DtoH" in d.name]
    nbytes = sum(d.args.get("bytes", 0) for d in copies)
    seconds = sum(d.end - d.ts for d in copies) * 1e-6
    if not nbytes or not seconds:
        return None
    return nbytes / 1e9 / seconds

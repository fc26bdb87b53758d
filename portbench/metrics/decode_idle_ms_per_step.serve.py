"""Decode loop: milliseconds a decode step in which the card ran no kernel,
in the traced call: the idle gaps that fell under ``engine.decode`` or one
of its phases (``engine.decode.launch``, ``.wait``, ``.readback``; not
``engine.decode_capture``) over the call's decode steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.records[ctx.traced_index]["decode_steps"]
    if not steps:
        return None
    idle = sum(s for name, s in ctx.trace["idle_gaps"]
               if name == "engine.decode" or name.startswith("engine.decode."))
    return 1e3 * idle / steps

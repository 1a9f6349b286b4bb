"""Decode step layer (serve/serve_step.py, models/): the token-expert rows
the MoE routers assigned to real tokens (a decode step's active lanes, a
prefill's prompt tokens) over every row the experts' products computed,
over every MoE layer call of the run: below 1 where a decode step
computes rows for idle lanes or a capacity buffer pads each expert to its
capacity.  The program's process-wide counters, which outlive the engine;
nothing where it keeps none."""


def read(run):
    try:
        from repro_torch.tracing import COUNTERS
    except ImportError:
        return None
    c = COUNTERS.read()
    routed, computed = c.get("moe.rows_routed", 0), \
        c.get("moe.rows_computed", 0)
    if not routed or not computed:
        return None
    return routed / computed

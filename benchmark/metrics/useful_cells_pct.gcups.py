"""Share of the cells the window's kernel launches walked that the
calls needed, in percent: the program's counters ``cells.needed`` (query
residues times target residues) over ``cells.walked`` (what the kernels'
walks step through: whole passes of query rows times each warp's steps
over the pack), kept while the window's profiler ran.  None where the
program keeps no such counters, or where they hold more needed cells
than the window's calls had (counts from outside the window)."""


def read(run):
    try:
        from pyopal_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    needed, walked = c.get("cells.needed", 0), c.get("cells.walked", 0)
    if not walked or needed > run.cells:
        return None
    return 100.0 * needed / walked

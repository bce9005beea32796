"""What the readers of an extension layer's spans share: the program's
span records inside the traced requests' roots of one name
(``layernorm``), from ``tiberate_tpu_torch.utils.trace`` through
``program.roots``; a program without such roots gives none, and the
readers return None."""

from tiberate_tpu_torch.utils import trace

from fhebench import program


def inside(run, root_name, name, parent_name=None):
    """For each traced root named ``root_name``: the records named
    ``name`` that it holds, those whose parent is named ``parent_name``
    where that is given."""
    roots = program.roots(run, root_name)
    if not roots:
        return []
    recs = trace.spans()
    names = {r.index: r.name for r in recs}
    return [[r for r in recs if r.root == root.index and r.name == name
             and r.index != root.index
             and parent_name in (None, names.get(r.parent))]
            for root in roots]

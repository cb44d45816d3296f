"""scfmesh.roofline_pct.md: the least time of a polarizable MD step's passes
over the energy mesh, the two full-multipole passes and one dipole pass per
traced PCG iteration (counts/scf_mesh.py), over the device time of the
kernels named in scfmesh.roofline_pct.md.d/, in %. None where the SCF's
matvec runs on a mesh of its own (``model.scf`` absent, or a reduced order
or grid), or where those kernels ran for no time."""

from benchmark.counts import scf_mesh
from benchmark.harness.core import kernel_names


def read(ctx):
    scf = ctx["config"]["model"].get("scf")
    if (not scf or scf.get("exact_adjoint", True)
            or scf.get("matvec_spread_order") not in (None, scf_mesh.ORDER)
            or scf.get("matvec_grid_div", 1) != 1):
        return None
    t = ctx.get("trace")
    if not t or not t["steps"] or not t["pcg_iters"]:
        return None
    names = kernel_names(ctx["bench"], ctx["metric"])
    dev_s = sum(s for fn, s in t["by_fn"].items() if fn in names)
    if dev_s <= 0:
        return None
    iters = t["pcg_iters"]
    work_s = scf_mesh.step_bound_s(ctx["shapes"], sum(iters) / len(iters))
    return 100.0 * work_s * t["steps"] / dev_s

"""``plan_builds_per_call.image``: plans the rescan entry builds per image
call (``rls.plan_build``: one build of ``device.plan_cache`` each, the
tables a call takes from its parameters, geometry and device alone); 0
where every call is served by the plans the warm-up built. None where the
program keeps no such plans (it has no ``device.plan_cache``)."""

import sys

from benchmark import spans

PLANS_MODULE = "rescan_line_sted_torch.device"


def read(run):
    if not hasattr(sys.modules.get(PLANS_MODULE), "plan_cache"):
        return None
    return spans.per_call(run, "rls.plan_build", "rls.image")

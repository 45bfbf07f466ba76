"""The plan contract (≙ ``blaze_tpu/serde``): ``plan.proto`` (a copy of
the reference's), a wire codec that speaks it without
``google.protobuf`` (``wire``), plan trees to and from its messages,
and ``run_task``, which runs one task from its TaskDefinition bytes."""

from .from_proto import expr_from_proto, plan_from_proto, run_task
from .to_proto import expr_to_proto, plan_to_proto, task_definition

__all__ = [
    "expr_to_proto", "plan_to_proto", "task_definition",
    "expr_from_proto", "plan_from_proto", "run_task",
]

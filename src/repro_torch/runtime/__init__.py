"""The run engine (counterpart of ``repro.runtime``): a :class:`RunSpec`
executed by an :class:`EdgeSession`, epochs driven by an
:class:`EpochRunner`."""

from repro_torch.runtime.runner import ConsoleHook, EpochReport, EpochRunner, RunHooks  # noqa: F401
from repro_torch.runtime.session import EdgeSession, StepEvent  # noqa: F401
from repro_torch.runtime.spec import RunSpec, RunSpecError  # noqa: F401

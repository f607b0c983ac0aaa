# Copy of i3rc_tpu/utils/errors.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Status/error policy.

The reference propagates an ``ErrorMessage`` status object through every call
(Code/ErrorMessages.f95:8-89): a message pile plus success/warning/failure
state, halted by ``printStatus`` (Code/userInterface_Unix.f95:21-54).

The TPU framework is Python, so failures raise exceptions eagerly at object
construction time (all validation happens on the host, outside jit).  This
module keeps the reference's two useful behaviors:

  * accumulating *all* validation problems before failing (the message pile),
  * non-fatal warnings that callers can inspect or log.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field


class ValidationError(ValueError):
    """Raised when object construction fails validation.

    Carries the full list of accumulated messages, like the reference's
    ErrorMessage pile printed by printStatus.
    """

    def __init__(self, messages):
        if isinstance(messages, str):
            messages = [messages]
        self.messages = list(messages)
        super().__init__("; ".join(self.messages))


class I3RCWarning(UserWarning):
    """Analog of the reference's warning state (setStateToWarning)."""


@dataclass
class Status:
    """Accumulates failures and warnings during validation.

    Mirrors ErrorMessages.f95 semantics: failures pile up; ``check()``
    raises once with everything collected (so a user sees all problems
    in one shot, as printStatus prints the whole history).
    """

    failures: list = field(default_factory=list)
    warnings: list = field(default_factory=list)

    def fail_if(self, condition: bool, message: str) -> None:
        if condition:
            self.failures.append(message)

    def warn_if(self, condition: bool, message: str) -> None:
        if condition:
            self.warnings.append(message)

    @property
    def is_failure(self) -> bool:
        return bool(self.failures)

    def check(self, context: str = "") -> None:
        """Emit warnings; raise ValidationError if any failure accumulated."""
        for w in self.warnings:
            warnings.warn(f"{context}: {w}" if context else w, I3RCWarning, stacklevel=3)
        if self.failures:
            msgs = [f"{context}: {m}" if context else m for m in self.failures]
            raise ValidationError(msgs)

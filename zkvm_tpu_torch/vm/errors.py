"""VMError hierarchy (upstream: slingshot/zkvm/src/errors.rs, ~30 variants)."""


class VMError(Exception):
    """Base VM error."""


class StackUnderflow(VMError):
    pass


class TypeNotCopyable(VMError):
    pass


class TypeNotDroppable(VMError):
    pass


class TypeNotPortable(VMError):
    pass


class TypeMismatch(VMError):
    pass


class FormatError(VMError):
    pass


class InvalidPredicateTree(VMError):
    pass


class UnsignedTx(VMError):
    pass


class AnchorMissing(VMError):
    pass


class FeeOverflow(VMError):
    pass


class InvalidSignature(VMError):
    pass


class ConstraintFailure(VMError):
    pass


class CommitmentNotOpen(VMError):
    pass


class RangeCheckFailure(VMError):
    pass


class TimeBoundsInvalid(VMError):
    pass


class ExtensionsDisabled(VMError):
    pass

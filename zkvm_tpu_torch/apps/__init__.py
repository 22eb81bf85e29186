"""L7 application helpers (SURVEY.md §2.8): accounts and token issuance —
programs for the ZkVM's vm.build_tx, the analogues of
slingshot/{accounts,token}.
"""

from .token import Token, issue_program  # noqa: F401
from .accounts import Receiver, Account, Utxo, pay_program  # noqa: F401

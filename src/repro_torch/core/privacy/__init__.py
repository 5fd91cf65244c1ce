"""Privacy accounting (paper section 4.1, Appendix A): the port's numpy copy
of the part of ``repro/core/privacy`` the trainer charges, the closed-form
Gaussian bounds and the per-silo ledger."""
from repro_torch.core.privacy.bounds import (composed_eps, gaussian_delta,
                                             gaussian_eps)
from repro_torch.core.privacy.ledger import PrivacyLedger

__all__ = ["composed_eps", "gaussian_delta", "gaussian_eps", "PrivacyLedger"]

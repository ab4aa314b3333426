from monortm_tpu_torch.utils.trace import (StageTimer, profile_trace, span,
                                           traced)

__all__ = ["StageTimer", "profile_trace", "span", "traced"]

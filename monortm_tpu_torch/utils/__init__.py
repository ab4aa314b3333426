from monortm_tpu_torch.utils.trace import (StageTimer, named_scope,
                                           profile_trace)

__all__ = ["StageTimer", "named_scope", "profile_trace"]

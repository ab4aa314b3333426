"""The benchmark of record of monortm_tpu_torch (see README.md)."""

"""Operator commands run through ``python -m cassmantle_tpu_torch``:
``quantize-weights`` (:mod:`.quantize_weights`) and ``lm-int8-ab``
(:mod:`.lm_int8_ab`)."""

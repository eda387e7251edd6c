"""Operator commands run through ``python -m cassmantle_tpu_torch``:
``quantize-weights`` (:mod:`.quantize_weights`), ``lm-int8-ab``
(:mod:`.lm_int8_ab`) and ``clip-report`` (:mod:`.clip_report`)."""

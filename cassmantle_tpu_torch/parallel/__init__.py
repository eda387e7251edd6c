"""Offline passes over the models: the W8A8 calibration
(:mod:`.calibrate`) and training on one device (:mod:`.train`: the
diffusion and consistency-distillation trainers and the optimizer;
:mod:`.lm_train`: the LM trainer)."""

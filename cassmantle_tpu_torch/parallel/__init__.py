"""Offline passes over the served models: the W8A8 calibration
(:mod:`.calibrate`)."""

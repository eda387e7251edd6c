"""The native state store's client (a copy of ``cassmantle_tpu/native``):
``client.py`` builds ``native/mantlestore.cc`` into the port's own
``_build/``, spawns nodes and speaks their RESP2 subset."""

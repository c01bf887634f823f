"""Systems under test, one module per kind of configuration (a
configuration's ``system`` names its module)."""

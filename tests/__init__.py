"""Test suite (a package, so that ``tests.*`` imports resolve here and not
to another installed ``tests`` package)."""

"""Drivers: each turns a traffic mix's parameters into calls of the
program's entry point, times the window, and checks what it produced. A
driver's ``run(ctx)`` returns a ``common.Result``."""

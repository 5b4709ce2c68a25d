"""Plain references that judge the port's outputs; they import nothing of it."""

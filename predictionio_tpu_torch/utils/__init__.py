"""Host-side helpers: id maps and step timing."""

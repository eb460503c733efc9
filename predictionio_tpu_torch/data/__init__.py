"""Host-side data: events, property maps, storage, id maps and synthetic
ratings."""

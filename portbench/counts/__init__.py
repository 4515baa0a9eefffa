"""Operation and byte counts computed from the configurations' published
shapes, never from what the program launches, and the card's peaks."""

"""CNN model definitions (AlexNet, VGG-16 and their minis)."""

"""Model definitions of the port: ViT-B/16 encoder, GPT-2 decoder, the
composite caption model and the weight bridge."""
